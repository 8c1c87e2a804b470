"""Parameter sharding rules: which dim of each member leaf a mesh axis splits.

Port of the training half of ``repro/sharding/rules.py``
(``param_pspec``, ``param_pspecs``, ``population_pspecs``,
``opt_pspecs``) and of its serving specs (``batch_pspecs``,
``cache_pspecs``).  A small table of name-based rules (column-parallel in,
row-parallel out, expert-parallel MoE) backed by a divisibility heuristic
for everything else; scanned-block leading axes are never sharded.

:class:`P` stands in for JAX's ``PartitionSpec``: a tuple with one entry a
dim, each ``None`` (the dim is whole on every rank), an axis name, or a
tuple of axis names.  Leaves are named by the paths of
:func:`repro_torch.core.population.tree_paths` (dict keys are strings,
list entries ints), which visit leaves in JAX's flattening order, so the
specs agree with the reference leaf by leaf.  ``stage_member_specs``
cuts the stacked blocks into pipeline stages.  Nothing inside a model is
laid out by a spec here: the ensemble engine gathers a member whole
before its forward (``core/shardplan.py``), a pipeline stage runs its own
slice of the blocks, and the serving engine reads ``batch_pspecs`` only
to decide whether a request's rows split over the data group
(``serving/engine.py``).  The reference's ``named`` (JAX shardings from
specs) has no counterpart.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import numpy as np

from repro_torch.core.population import tree_map, tree_paths

Tree = Any


class P(tuple):
    """A member leaf's partition spec: ``P(None, "model")`` splits dim 1
    over the ``model`` axis; ``P()`` replicates the leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    """A leaf of a spec tree (which ``tree_map`` must not descend into)."""
    return x is None or isinstance(x, P)


# leaf-name patterns -> which *logical* dim gets the model axis
# (negative indices from the end; None = replicate)
_COL_PAR = re.compile(r"(wq|wk|wv|w1|w3|in_proj|dt_proj|w_uk|w_uv|wr|wg|frame_proj|patch_proj)$")
_ROW_PAR = re.compile(r"(wo|w2|out_proj|x_proj)$")
_REPLICATE = re.compile(
    r"(scale|bias|^b$|bq|bk|bv|b1|b2|mu|w0|u$|beta|router|conv_w|conv_b|A_log|^D$"
    r"|dt_bias|w_lora_a|w_lora_b|w_dkv|w_krope|pos|enc_pos|ln)"
)


def _leaf_name(path: Sequence) -> str:
    return str(path[-1]) if path else ""


def _has_key(path: Sequence, *names: str) -> bool:
    return any(isinstance(p, str) and p in names for p in path)


def _is_blocks_leaf(path: Sequence) -> bool:
    return _has_key(path, "blocks", "enc_blocks")


def _heuristic(shape: Tuple[int, ...], model: int, skip_first: bool) -> P:
    """Shard the right-most dim divisible by the model axis (>= 2x)."""
    spec = [None] * len(shape)
    lo = 1 if skip_first else 0
    for i in range(len(shape) - 1, lo - 1, -1):
        if shape[i] % model == 0 and shape[i] // model >= 2:
            spec[i] = "model"
            break
    return P(*spec)


def param_pspec(path: Sequence, leaf, cfg, model_size: int) -> P:
    """The spec of one member leaf at ``path`` (``cfg`` is unused, as in
    the reference)."""
    del cfg
    name = _leaf_name(path)
    shape = tuple(int(s) for s in leaf.shape)
    nb = _is_blocks_leaf(path)
    off = 1 if nb else 0  # scanned layer axis leads blocks leaves

    if _REPLICATE.search(name):
        return P()
    if len(shape) - off < 2:
        return P()

    def with_model_at(dim_from_end: int) -> P:
        idx = len(shape) - 1 - dim_from_end
        if shape[idx] % model_size == 0 and shape[idx] // model_size >= 2:
            spec = [None] * len(shape)
            spec[idx] = "model"
            return P(*spec)
        return _heuristic(shape, model_size, nb)

    # MoE experts: expert-parallel over the model axis
    if _has_key(path, "experts"):
        e_idx = off  # (L, E, D, F) or (E, D, F)
        if shape[e_idx] % model_size == 0:
            spec = [None] * len(shape)
            spec[e_idx] = "model"
            return P(*spec)
        return _heuristic(shape, model_size, nb)

    if name == "tok":  # (V, D): shard vocab (row-parallel embed + rsc logits)
        return with_model_at(1)
    if name == "w" and _has_key(path, "lm_head"):
        return with_model_at(0)  # (D, V): column-parallel head
    if _COL_PAR.search(name):
        return with_model_at(0)  # output features sharded
    if _ROW_PAR.search(name):
        return with_model_at(1)  # input features sharded
    return _heuristic(shape, model_size, nb)


def param_pspecs(params: Tree, cfg, mesh) -> Tree:
    """Specs for every leaf of a member tree (tensors, ``meta`` tensors or
    anything with a ``shape``) on ``mesh``'s ``model`` axis."""
    model = int(mesh.shape["model"])
    specs = iter([param_pspec(path, leaf, cfg, model)
                  for path, leaf in tree_paths(params)])
    return tree_map(lambda _: next(specs), params)


def _lead(pop_axes: Sequence[str]):
    return pop_axes[0] if len(pop_axes) == 1 else tuple(pop_axes)


def stage_member_specs(member_specs: Tree, layer_ids: Tree,
                       pipe_axis: str = "pipe") -> Tree:
    """The member specs of a pipeline mesh: ``pipe_axis`` on the layer
    axis (dim 0) of every stacked-blocks leaf, known by an array-valued
    ``layer_ids`` leaf (:func:`repro_torch.core.layer_index.
    infer_layer_ids`), not by its path, so the per-block leaves of a
    list-of-blocks model stay replicated.  Everything else (embed, head,
    norms) stays replicated over the pipe axis.  Raises when the layer
    axis is already split by another axis."""

    def one(spec, lid):
        if isinstance(lid, (int, np.integer)):
            return spec
        entries = tuple(spec) if spec is not None else ()
        if entries and entries[0] is not None:
            raise ValueError(
                f"scanned layer axis already sharded by {entries[0]!r}; "
                "cannot also stage-split it")
        return P(pipe_axis, *entries[1:])

    return tree_map(one, member_specs, layer_ids, is_leaf=is_spec)


def population_pspecs(member_specs: Tree, pop_axes=("ens",)) -> Tree:
    """Specs of a stacked population: the leading axis over the population
    axes, every member dim its member-level spec (``None`` = ``P()``)."""
    lead = _lead(pop_axes)
    return tree_map(lambda s: P(lead, *(tuple(s) if s is not None else ())),
                    member_specs, is_leaf=is_spec)


def opt_pspecs(opt_state: dict, pop_specs: Tree, pop_axes=("ens",)) -> dict:
    """Specs of a population's optimizer state: the moments (``mu``,
    ``nu``: what WASH+Opt shuffles) mirror the population's specs, so a
    moment's shard lines up with its parameter's; the rest (the step
    counter) is split over the population axes only."""
    lead = _lead(pop_axes)
    return {k: pop_specs if k in ("mu", "nu")
            else tree_map(lambda _: P(lead), opt_state[k])
            for k in opt_state}


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry(axes: Tuple[str, ...]):
    """A spec entry over ``axes``: one axis as its name, as JAX's
    ``PartitionSpec`` normalizes it."""
    return axes[0] if len(axes) == 1 else axes


def batch_pspecs(cfg, mesh, batch_size: int) -> dict:
    """Specs of a request's inputs: the batch dim over the pod and data
    axes when ``batch_size`` divides over them, else ``None`` (every rank
    holds the whole batch)."""
    dax = _data_axes(mesh)
    nd = int(np.prod([mesh.shape[a] for a in dax]))
    bspec = _entry(dax) if (dax and batch_size % nd == 0) else None
    out = {"tokens": P(bspec, None)}
    if cfg.frontend == "audio":
        out["frames"] = P(bspec, None, None)
    if cfg.frontend == "vision":
        out["patches"] = P(bspec, None, None)
    return out


def cache_pspecs(cache_shapes: Tree, cfg, mesh, batch: int) -> Tree:
    """Specs of the decode cache (leaves with a ``shape``, named as
    ``models.transformer.init_cache`` names them): the KV ring (L, B, cap,
    kv, hd) and MLA's latent ring (L, B, cap, r) over the data axes by
    batch when it divides, else their context axis over every data and
    model rank (context parallelism); the cross-attention, Mamba and
    rwkv6 states by batch, their inner dim over ``model`` where it
    divides; ``pos_ids`` replicated."""
    del cfg
    dax = _data_axes(mesh)
    nd = int(np.prod([mesh.shape[a] for a in dax])) if dax else 1
    model = int(mesh.shape["model"])
    batch_ok = bool(dax) and batch % nd == 0
    bax = _entry(dax) if batch_ok else None

    def ring(shape, trailing: int) -> P:
        if batch_ok:
            return P(None, bax, "model" if shape[2] % model == 0 else None,
                     *(None,) * trailing)
        ctx = _entry(dax + ("model",))
        return P(None, None, ctx if shape[2] % (nd * model) == 0 else None,
                 *(None,) * trailing)

    def spec_for(path, leaf) -> P:
        name = _leaf_name(path)
        shape = tuple(int(s) for s in leaf.shape)
        if name in ("k", "v"):  # (L, B, cap, kv, hd)
            return ring(shape, 2)
        if name in ("ckv", "krope"):  # (L, B, cap, r)
            return ring(shape, 1)
        if name in ("xk", "xv"):  # (L, B, frames, kv, hd)
            return P(None, bax, None, None, None)
        if name == "h":  # mamba (L, B, DI, S)
            return P(None, bax, "model" if shape[2] % model == 0 else None,
                     None)
        if name == "conv":  # (L, B, k-1, DI)
            return P(None, bax, None,
                     "model" if shape[3] % model == 0 else None)
        if name == "S":  # rwkv (L, B, H, hd, hd)
            return P(None, bax, None, None, None)
        if name in ("x_tm", "x_cm"):  # (L, B, D)
            return P(None, bax, "model" if shape[2] % model == 0 else None)
        return P()  # pos_ids and anything else

    specs = iter([spec_for(p, leaf) for p, leaf in tree_paths(cache_shapes)])
    return tree_map(lambda _: next(specs), cache_shapes)
