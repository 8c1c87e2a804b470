"""Shard-local WASH mixing plans for ens×data×model meshes.

Port of ``repro/core/shardplan.py``.  On a mesh with more than one axis
each mesh axis has a role (:func:`classify_roles`): ``ENS`` axes carry
the population (the ``ens`` axis, plus the data axes when the population
divides over them: every rank then holds whole members); leftover
``DATA`` axes split each member's batch (gradients are averaged over
them); ``MODEL`` axes shard members, through the per-leaf partition
specs (``sharding/rules.py``); a ``pipe`` axis larger than 1 splits the
stacked blocks into contiguous pipeline stages (``rules.
stage_member_specs``), each with its own slice of the per-layer budget.
A size-1 ``pipe`` axis is dropped.

The planner (:func:`plan_population_mixing`) is host arithmetic on the
member's shapes and specs: each leaf's local shard shape and its slice of
the global bucketed budget (``k_per_local = k_per_global // num_shards``,
per layer for stacked-blocks leaves), so the shards together never send
more than the global plan.  :func:`static_shard_mix_comm` counts what a
member sends in exact float64.

On the ranks (a :class:`repro_torch.launch.mesh.HostMesh`), a leaf's plan
seed is ``leaf_seed(seed, index)`` folded with the rank's linearized
coordinate over the axes that shard that leaf (:func:`_shard_position`):
shards draw independent plans, replicas of one shard the same one, and a
leaf that is not sharded draws the global plan bitwise.
:func:`mix_collective_sharded` applies them over the population group
(``core/shuffle.py``'s ring; at one population shard, the bucketed
shuffle kernel), and PAPA's mean runs over the same group, elementwise,
so it is exact on shards.  A stage-split leaf's plan is this rank's
stage's alone (:func:`build_local_plans`); every rank of a stage draws
the same one, and the leaves replicated over the stages draw the same
plan on every stage.  The standalone mixer
(:func:`make_shardlocal_mixer`, the dry run's) builds those plans and
mixes one rank's shards by itself.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import shuffle as shf
from repro_torch.core.layer_index import (infer_layer_ids, stage_layer_bounds,
                                         stage_of_depth, total_layers)
from repro_torch.core.mixing import (MixingConfig, momentum_like_leaves,
                                     papa_blocked)
from repro_torch.core.population import all_gather_dims, tree_leaves, tree_map
from repro_torch.core.prng import fold_in, leaf_seed
from repro_torch.core.schedules import (layer_probability,
                                        layer_probability_array)
from repro_torch.sharding.rules import is_spec

Tree = Any

PIPE_AXIS = "pipe"


# ---------------------------------------------------------------------------
# axis classification
# ---------------------------------------------------------------------------


def data_like_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry batch/data parallelism."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


class AxisRole(enum.Enum):
    """What a mesh axis means to the population planner."""

    ENS = "ens"      # carries the population (the ring runs here)
    DATA = "data"    # splits each member's batch (gradients averaged here)
    MODEL = "model"  # shards member parameters (through the specs)
    PIPE = "pipe"    # partitions each member's blocks into pipeline stages


@dataclasses.dataclass(frozen=True)
class AxisRoles:
    """The role of every axis of one mesh (size-1 pipe axes are MODEL)."""

    roles: Tuple[Tuple[str, AxisRole], ...]

    def axes(self, role: AxisRole) -> Tuple[str, ...]:
        return tuple(a for a, r in self.roles if r == role)

    @property
    def pop_axes(self) -> Tuple[str, ...]:
        return self.axes(AxisRole.ENS)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.axes(AxisRole.DATA)

    @property
    def model_axes(self) -> Tuple[str, ...]:
        return self.axes(AxisRole.MODEL)

    @property
    def pipe_axis(self) -> Optional[str]:
        p = self.axes(AxisRole.PIPE)
        return p[0] if p else None

    def role_of(self, axis: str) -> Optional[AxisRole]:
        return dict(self.roles).get(axis)


def classify_roles(mesh, n: int) -> AxisRoles:
    """The role of every axis of ``mesh`` (anything with ``axis_names`` and
    a ``shape`` dict) for a population of ``n``.  Data axes join the
    population when it divides over ens×data (each rank then holds whole
    members, and a member's update needs no gradient collective);
    otherwise they split batches.  (The reference lets its standalone
    mixer pin the split, derived from its population specs; the port's
    :func:`make_shardlocal_mixer` takes the roles from here, through
    :func:`plan_population_mixing`.)"""
    names = tuple(mesh.axis_names)
    if "ens" not in names:
        raise ValueError(f"population mesh needs an 'ens' axis; got {names}")
    e = int(mesh.shape["ens"])
    if n % e:
        raise ValueError(
            f"population {n} must divide over ens axis of size {e}")
    # size-1 data axes carry nothing: keep them out of both groups so
    # degenerate meshes take the trivial (bitwise-identical) body
    data = tuple(a for a in data_like_axes(mesh) if int(mesh.shape[a]) > 1)
    dsz = int(np.prod([mesh.shape[a] for a in data])) if data else 1
    if data and (n // e) % dsz == 0:
        pop_axes, dp_axes = ("ens",) + data, ()
    else:
        pop_axes, dp_axes = ("ens",), data

    roles = []
    for a in names:
        if a in pop_axes:
            roles.append((a, AxisRole.ENS))
        elif a in dp_axes:
            roles.append((a, AxisRole.DATA))
        elif a == PIPE_AXIS and int(mesh.shape[a]) > 1:
            roles.append((a, AxisRole.PIPE))
        else:
            roles.append((a, AxisRole.MODEL))
    return AxisRoles(roles=tuple(roles))


# ---------------------------------------------------------------------------
# the static planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafShardInfo:
    """Static per-leaf shard geometry + bucketed budget (host-side only)."""

    index: int                      # plan-seed fold index (leaf order)
    member_shape: Tuple[int, ...]   # global member shape
    local_shape: Tuple[int, ...]    # this rank's member-shard shape
    sharded_dims: Tuple[Tuple[int, str, int], ...]  # (dim, axis, local_size)
    num_shards: int                 # model shards only (pipe excluded)
    layered: bool
    counts_local: Optional[Tuple[int, ...]]  # layered per-layer budget (all L)
    k_per_local: int                # per-bucket count (0: no plan)
    sel_local: int                  # scalars selected per shard per step
    d_local: int                    # flat size of the local member shard
    d_rest_local: int               # layered: per-layer local flat size
    # pipeline fields (single-stage plans: stage=0, bounds/k_per None)
    stage: int = 0                  # owner stage of a non-stage-split leaf
    stage_bounds: Optional[Tuple[Tuple[int, int], ...]] = None
    stage_k_per: Optional[Tuple[int, ...]] = None  # per-stage bucket budget

    @property
    def shard_axes(self) -> Tuple[str, ...]:
        return tuple(a for _, a, _ in self.sharded_dims)

    @property
    def stage_split(self) -> bool:
        return self.stage_k_per is not None


@dataclasses.dataclass(frozen=True)
class PopulationPlan:
    """Everything the engine needs to mix a sharded population, built once
    on the host by :func:`plan_population_mixing`."""

    roles: AxisRoles
    axis_sizes: Tuple[Tuple[str, int], ...]
    num_stages: int                 # pipe-axis size (1: no pipeline)
    n: int                          # global population
    n_local: int                    # members per population shard
    infos: Tuple[LeafShardInfo, ...]  # leaf order
    mcfg: MixingConfig

    @property
    def pop_axes(self) -> Tuple[str, ...]:
        return self.roles.pop_axes

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.roles.dp_axes

    @property
    def any_sharded(self) -> bool:
        return any(i.sharded_dims for i in self.infos)

    def size(self, axis: str) -> int:
        return dict(self.axis_sizes)[axis]


def _spec_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_axes(axes: Tuple[str, ...], mesh, roles: AxisRoles) -> None:
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"param spec uses axis {a!r}, not an axis of "
                             f"the mesh {tuple(mesh.axis_names)}")
        if roles.role_of(a) in (AxisRole.ENS, AxisRole.DATA):
            raise ValueError(
                f"param spec uses axis {a!r}, which carries the "
                f"population/batch — member specs may only use model/"
                f"pipe-type axes (mesh axes {tuple(mesh.axis_names)}, "
                f"roles {roles.roles})")


def check_spec_axes(member_specs: Tree, mesh, roles: AxisRoles) -> None:
    """Refuse, from the specs alone (before any parameter exists), a
    member spec that names an axis the mesh lacks or one that carries
    the population or the batch."""
    for spec in tree_leaves(member_specs, is_leaf=is_spec):
        for e in (spec or ()):
            if e is not None:
                _check_axes(_spec_axes(e), mesh, roles)


def _local_leaf_geometry(shape, spec, mesh, roles: AxisRoles, layered=False):
    """Spec slicing: the rank-local shard shape of one *member* leaf.

    Returns ``(local_shape, sharded_dims, num_shards, pipe_stages)``.  The
    pipe axis may only split the layer axis (dim 0) of a stacked-blocks
    leaf; it never enters ``sharded_dims`` (plan seeds do not fold the
    stage) and takes uneven layer counts (``local[0]`` is the floor)."""
    entries = tuple(spec) if spec is not None else ()
    local = list(shape)
    sharded_dims = []
    num_shards = 1
    pipe_stages = 1
    pipe = roles.pipe_axis
    for dim, e in enumerate(entries):
        if e is None:
            continue
        axes = _spec_axes(e)
        _check_axes(axes, mesh, roles)
        if pipe is not None and pipe in axes:
            if axes != (pipe,):
                raise ValueError(
                    f"the pipe axis cannot share a dim with {axes}")
            if not (layered and dim == 0):
                raise ValueError(
                    f"the pipe axis may only shard the scanned layer axis "
                    f"(dim 0) of stacked-blocks leaves; got dim {dim} of "
                    f"shape {shape} (layered={layered})")
            pipe_stages = int(mesh.shape[pipe])
            local[dim] = shape[0] // pipe_stages
            continue
        sz = int(np.prod([mesh.shape[a] for a in axes]))
        if sz == 1:
            continue
        if local[dim] % sz:
            raise ValueError(
                f"leaf dim {dim} of shape {shape} not divisible by mesh "
                f"axes {axes} (size {sz})")
        local[dim] //= sz
        if len(axes) != 1:
            raise ValueError(
                f"multi-axis sharding of one dim ({axes}) is not supported "
                "by the shard-local planner yet")
        sharded_dims.append((dim, axes[0], local[dim]))
        num_shards *= sz
    return tuple(local), tuple(sharded_dims), num_shards, pipe_stages


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64)) if len(shape) else 1


def plan_population_mixing(mesh, member_tpl: Tree, member_specs: Tree,
                           mcfg: MixingConfig, layer_ids: Tree, tl: int,
                           n: int) -> PopulationPlan:
    """The static shard-local mixing plan of a population of ``n``.

    ``mesh`` is anything with ``axis_names`` and a ``shape`` dict (a
    :class:`~repro_torch.launch.mesh.HostMesh`, or a stand-in);
    ``member_tpl`` a one-member tree of tensors (``meta`` ones do);
    ``member_specs`` its tree of :class:`repro_torch.sharding.rules.P`
    (``None`` / ``P()``: replicated); ``layer_ids`` / ``tl`` as for
    :func:`repro_torch.core.shuffle.make_plan`."""
    roles = classify_roles(mesh, n)
    pop_axes = roles.pop_axes
    pipe = roles.pipe_axis
    num_stages = int(mesh.shape[pipe]) if pipe is not None else 1
    leaves = tree_leaves(member_tpl)
    spec_leaves = tree_leaves(member_specs, is_leaf=is_spec)
    lid_leaves = tree_leaves(layer_ids)
    if not len(leaves) == len(spec_leaves) == len(lid_leaves):
        raise ValueError(
            f"member/specs/layer_ids trees disagree: {len(leaves)} vs "
            f"{len(spec_leaves)} vs {len(lid_leaves)} leaves")

    infos = []
    for i, (leaf, spec, lid) in enumerate(zip(leaves, spec_leaves,
                                              lid_leaves)):
        shape = tuple(int(s) for s in leaf.shape)
        layered = not isinstance(lid, (int, np.integer))
        local, sharded_dims, num_shards, pipe_stages = _local_leaf_geometry(
            shape, spec, mesh, roles, layered=layered)
        d_local = _numel(local)
        if layered:
            if not shape:
                raise ValueError(f"layered leaf {i} must have a layer axis")
            if any(d == 0 for d, _, _ in sharded_dims):
                raise ValueError(
                    f"leaf {i}: the scanned layer axis cannot be sharded")
            L = shape[0]
            p_vec = np.clip(layer_probability_array(mcfg.base_p, lid, tl,
                                                    mcfg.schedule), 0.0, 1.0)
            d_rest = _numel(shape[1:])
            d_rest_local = _numel(local[1:])
            counts_global = [int(round(float(p_vec[l]) * d_rest))
                             for l in range(L)]
            counts_local = tuple(c // num_shards for c in counts_global)
            if pipe_stages > 1:
                # per-stage budgets: each stage pools only its own layers'
                # counts and takes an independent floor, so the shuffle
                # ring never crosses a stage boundary
                bounds = stage_layer_bounds(L, pipe_stages)
                stage_k_per = tuple(
                    sum(min(c, d_rest_local)
                        for c in counts_local[lo:hi] if c > 0) // n
                    for lo, hi in bounds)
                k_per = sum(stage_k_per)
                infos.append(LeafShardInfo(
                    index=i, member_shape=shape, local_shape=local,
                    sharded_dims=sharded_dims, num_shards=num_shards,
                    layered=True, counts_local=counts_local,
                    k_per_local=k_per, sel_local=k_per * n, d_local=d_local,
                    d_rest_local=d_rest_local, stage_bounds=bounds,
                    stage_k_per=stage_k_per))
                continue
            pooled = sum(min(c, d_rest_local) for c in counts_local if c > 0)
            k_per = pooled // n
            infos.append(LeafShardInfo(
                index=i, member_shape=shape, local_shape=local,
                sharded_dims=sharded_dims, num_shards=num_shards,
                layered=True, counts_local=counts_local, k_per_local=k_per,
                sel_local=k_per * n, d_local=d_local,
                d_rest_local=d_rest_local))
            continue
        p_l = layer_probability(mcfg.base_p, int(lid), tl, mcfg.schedule)
        k_per_global = (shf.bucket_count(_numel(shape), n, min(p_l, 1.0))
                        if p_l > 0.0 else 0)
        k_per_local = k_per_global // num_shards
        infos.append(LeafShardInfo(
            index=i, member_shape=shape, local_shape=local,
            sharded_dims=sharded_dims, num_shards=num_shards, layered=False,
            counts_local=None, k_per_local=k_per_local,
            sel_local=k_per_local * n, d_local=d_local, d_rest_local=0,
            stage=(stage_of_depth(int(lid), tl - 2, num_stages)
                   if num_stages > 1 else 0)))

    sizes = {a: int(mesh.shape[a]) for a in mesh.axis_names}
    m = int(np.prod([sizes[a] for a in pop_axes]))
    if n % m:
        raise ValueError(
            f"population {n} must divide over pop axes {pop_axes} (size {m})")
    return PopulationPlan(roles=roles, axis_sizes=tuple(sizes.items()),
                          num_stages=num_stages, n=n, n_local=n // m,
                          infos=tuple(infos), mcfg=mcfg)


# ---------------------------------------------------------------------------
# on the ranks (a HostMesh)
# ---------------------------------------------------------------------------


def _shard_position(info: LeafShardInfo, pplan: PopulationPlan, mesh) -> int:
    """This rank's linearized coordinate over the axes that shard ``info``
    (0 for a leaf no axis shards, on every rank)."""
    pos = 0
    for _, a, _ in info.sharded_dims:
        pos = pos * pplan.size(a) + mesh.coords[a]
    return pos


def check_even_stages(pplan: PopulationPlan) -> None:
    """Refuse stage-split leaves whose layers do not divide over the
    stages: the planner's accounting takes uneven stages, the engine's
    stage shards must share one shape."""
    for info in pplan.infos:
        if info.stage_split and info.member_shape[0] % pplan.num_stages:
            raise ValueError(
                f"stacked-blocks leaf of {info.member_shape[0]} layers does "
                f"not split evenly over {pplan.num_stages} pipeline stages")


def stage_split_plan(seed: int, info: LeafShardInfo, pplan: PopulationPlan,
                     stage: int, device) -> Optional[torch.Tensor]:
    """Stage ``stage``'s plan of a stage-split leaf: the layered plan of
    its layers ``[lo, hi)`` from ``fold_in(seed, stage)`` over
    ``counts_local[lo:hi]``, indexing the stage's flat shard, ``(n,
    stage_k_per[stage])`` (None when the stage draws nothing).  It is
    the reference's column block of that stage in its concatenated plan;
    the reference's other columns, masked to an out-of-range index, are
    never built, so every index lies in the shard."""
    lo, hi = info.stage_bounds[stage]
    if info.stage_k_per[stage] == 0:
        return None
    return shf.bucketed_plan_layered(
        fold_in(seed, stage), hi - lo, info.d_rest_local, pplan.n, None,
        counts=info.counts_local[lo:hi], device=device)


def build_local_plans(seed: int, pplan: PopulationPlan, mesh,
                      device=None) -> List[Optional[torch.Tensor]]:
    """This rank's bucketed plans, one a leaf in leaf order (None: no
    plan), each indexing the leaf's flat local member shard, on
    ``device`` (default: the mesh's).  Leaf i's seed is ``leaf_seed(seed,
    i)``, folded with the shard position when an axis splits the leaf;
    a stage-split leaf takes this rank's stage's plan
    (:func:`stage_split_plan`)."""
    check_even_stages(pplan)
    device = mesh.device if device is None else device
    plans = []
    for info in pplan.infos:
        if info.sel_local == 0:
            plans.append(None)
            continue
        k = leaf_seed(seed, info.index)
        if info.sharded_dims:
            k = fold_in(k, _shard_position(info, pplan, mesh))
        if info.stage_split:
            plans.append(stage_split_plan(
                k, info, pplan, mesh.coords[pplan.roles.pipe_axis], device))
        elif info.layered:
            plans.append(shf.bucketed_plan_layered(
                k, len(info.counts_local), info.d_rest_local, pplan.n, None,
                counts=info.counts_local, device=device))
        else:
            plans.append(shf.bucketed_plan(k, info.d_local, pplan.n, 0.0,
                                           k_per=info.k_per_local,
                                           device=device))
    return plans


def _model_group(info: LeafShardInfo, mesh):
    if any(a not in mesh.model.axes for a in info.shard_axes):
        raise ValueError(f"leaf {info.index} is sharded over "
                         f"{info.shard_axes}, not the model axes "
                         f"{mesh.model.axes}")
    return mesh.model


def shard_dims(pplan: PopulationPlan) -> List[Tuple[int, ...]]:
    """The member dims the model axes split, a tuple for each leaf."""
    return [tuple(d for d, _, _ in info.sharded_dims) for info in pplan.infos]


def stage_split(pplan: PopulationPlan) -> List[bool]:
    """For each leaf, whether the pipe axis splits its layer dim."""
    return [info.stage_split for info in pplan.infos]


def stage_population(tree: Tree, pplan: PopulationPlan, stage: int) -> Tree:
    """Stage ``stage``'s shard of full member leaves (leaves ``(n_local,
    L, ...)``): layers ``[lo, hi)`` of each stage-split leaf, each its
    own contiguous tensor; the other leaves whole."""
    it = iter(pplan.infos)

    def slice_(x):
        info = next(it)
        if not info.stage_split:
            return x
        lo, hi = info.stage_bounds[stage]
        return x.narrow(1, lo, hi - lo).contiguous()

    return tree_map(slice_, tree)


def all_gather_population(params: Tree, pplan: PopulationPlan, mesh) -> Tree:
    """Full member leaves from a block of model shards (leaves carry a
    leading local-population axis, so member dim d is leaf dim d + 1): an
    all-gather over the model group along each split dim; moves values,
    computes nothing."""
    it = iter(pplan.infos)

    def gather(x):
        info = next(it)
        if not info.sharded_dims:
            return x
        return all_gather_dims(x, [d for d, _, _ in info.sharded_dims],
                               _model_group(info, mesh))

    return tree_map(gather, params)


def shard_population(tree: Tree, pplan: PopulationPlan, mesh) -> Tree:
    """This rank's model shard of full member leaves, each leaf
    contiguous: the inverse of :func:`all_gather_population`, an exact
    slice."""
    it = iter(pplan.infos)

    def slice_(x):
        info = next(it)
        _model_group(info, mesh)
        for dim, a, lsz in info.sharded_dims:
            x = x.narrow(dim + 1, mesh.coords[a] * lsz, lsz)
        return x.contiguous()

    return tree_map(slice_, tree)


def mix_collective_sharded(seed: int, params: Tree, opt_state: Optional[Tree],
                           cfg: MixingConfig, pplan: PopulationPlan, mesh,
                           gate: bool) -> Tuple[Tree, Optional[Tree]]:
    """Shard-local mixing of this rank's block of member shards, in place.

    WASH: this rank's plans (:func:`build_local_plans`) applied over the
    population group, ``mesh.pop`` (the ring across ranks; at one
    population shard, the bucketed shuffle kernel), replayed on the
    moments under WASH+Opt.  PAPA and PAPA-all: the mean over the
    population group, elementwise, so exact on shards.  A closed
    ``gate`` (the host's ``mixing_due``) mixes nothing.  Comm is counted
    on the host (:func:`static_shard_mix_comm`)."""
    if cfg.kind == "none" or not gate:
        return params, opt_state
    if cfg.kind in ("wash", "wash_opt"):
        flat = build_local_plans(seed, pplan, mesh)
        it = iter(flat)
        plan = tree_map(lambda _: next(it), params)
        shf.apply_plan_collective_blocked(plan, params, mesh.pop)
        if cfg.shuffles_optimizer() and opt_state is not None:
            for moments in momentum_like_leaves(opt_state, params).values():
                shf.apply_plan_collective_blocked(plan, moments, mesh.pop)
        return params, opt_state
    return papa_blocked(params, cfg, mesh.pop), opt_state


# ---------------------------------------------------------------------------
# exact host-side communication accounting (paper Table 1, per shard)
# ---------------------------------------------------------------------------


def shard_leaf_volumes(pplan: PopulationPlan) -> Dict[int, Tuple[float, int]]:
    """``{leaf_index: (scalars sent per member per shard, num_shards)}``
    for a WASH mixing step (bucket 0 is the identity: ``sel·(N-1)/N``)."""
    return {info.index: (float(info.sel_local * (pplan.n - 1) / pplan.n),
                         info.num_shards)
            for info in pplan.infos}


def _opt_replay_factor(pplan: PopulationPlan, opt_state) -> int:
    """1 + number of optimizer moment trees the WASH plan is replayed on."""
    if not (pplan.mcfg.shuffles_optimizer() and opt_state is not None):
        return 1
    return 1 + len(momentum_like_leaves(opt_state, None))


def static_stage_mix_comm(pplan: PopulationPlan, stage: int,
                          opt_state: Optional[Tree] = None) -> float:
    """Exact scalars sent per member by pipeline stage ``stage`` on a
    mixing-due step, in host float64: stage-split leaves their stage's
    budget, every other leaf on its owner stage, so each scalar is
    counted once."""
    cfg = pplan.mcfg
    if cfg.kind == "none":
        return 0.0
    if stage < 0 or stage >= pplan.num_stages:
        raise ValueError(
            f"stage {stage} out of range for {pplan.num_stages} stages")
    if cfg.kind in ("papa", "papa_all"):
        total = 0
        for info in pplan.infos:
            size = _numel(info.member_shape)
            if info.stage_split:
                lo, hi = info.stage_bounds[stage]
                total += (hi - lo) * (size // info.member_shape[0])
            elif info.stage == stage:
                total += size
        return float(total)
    comm = 0.0
    for info in pplan.infos:
        if info.stage_split:
            sel_s = info.stage_k_per[stage] * pplan.n
            comm += sel_s * (pplan.n - 1) / pplan.n * info.num_shards
        elif info.stage == stage:
            comm += info.sel_local * (pplan.n - 1) / pplan.n * info.num_shards
    return float(comm * _opt_replay_factor(pplan, opt_state))


def static_shard_mix_comm(pplan: PopulationPlan,
                          opt_state: Optional[Tree] = None) -> float:
    """Exact scalars sent per member on a mixing-due step, summed over the
    member's shards, in host float64 (equal to
    :func:`repro_torch.core.mixing.static_mix_comm` when no leaf is
    sharded); on a pipeline mesh, the literal sum of
    :func:`static_stage_mix_comm` over the stages."""
    cfg = pplan.mcfg
    if cfg.kind == "none":
        return 0.0
    if pplan.num_stages > 1:
        return float(sum(static_stage_mix_comm(pplan, s, opt_state=opt_state)
                         for s in range(pplan.num_stages)))
    if cfg.kind in ("papa", "papa_all"):
        return float(sum(_numel(i.member_shape) for i in pplan.infos))
    comm = sum(sent * num for sent, num in shard_leaf_volumes(pplan).values())
    return float(comm * _opt_replay_factor(pplan, opt_state))


# ---------------------------------------------------------------------------
# standalone mixer (launch/dryrun.py's ``--mixing *_local``)
# ---------------------------------------------------------------------------


def make_shardlocal_mixer(mesh, mcfg: MixingConfig, num_blocks: int,
                          pop_specs: Tree, opt_specs: Tree):
    """A shard-local WASH / PAPA mixing step over this rank's block of
    member shards, the reference's standalone mixer
    (``repro/core/shardplan.py::make_shardlocal_mixer``) as a closure
    over :func:`mix_collective_sharded`.

    ``pop_specs`` are the stacked population's specs (the leading entry
    the population axes, the rest the member's sharding): the member
    specs and the population axes come from them.  Member shapes and the
    population size are read off the block passed in (each local shard
    times the sizes of the axes that split it), so one mixer serves any
    tree matching ``pop_specs``.

    Returns ``mixer(pop_local, opt_local, seed) -> (pop, opt,
    comm_total)``, mixing in place; ``comm_total`` is the scalars the
    whole population sends on the step, exact host float64
    (:func:`static_shard_mix_comm` times the population; the reference
    returns it as a float32 device scalar)."""
    member_specs = tree_map(lambda s: type(s)(*tuple(s)[1:]), pop_specs,
                            is_leaf=is_spec)
    first = tree_leaves(pop_specs, is_leaf=is_spec)[0]
    lead = tuple(first)[0]
    pop_axes = (lead,) if isinstance(lead, str) else tuple(lead)
    m_pop = int(np.prod([int(mesh.shape[a]) for a in pop_axes]))

    def global_member(pop_local: Tree) -> Tree:
        def one(leaf, spec):
            shape = list(leaf.shape[1:])
            for dim, e in enumerate(tuple(spec) if spec is not None else ()):
                for a in () if e is None else (e,) if isinstance(e, str) \
                        else tuple(e):
                    shape[dim] *= int(mesh.shape[a])
            return torch.empty(shape, dtype=leaf.dtype, device="meta")

        return tree_map(one, pop_local, member_specs)

    def mixer(pop_local: Tree, opt_local: Optional[Tree], seed: int):
        member_tpl = global_member(pop_local)
        n = tree_leaves(pop_local)[0].shape[0] * m_pop
        lids = infer_layer_ids(member_tpl, num_blocks)
        pplan = plan_population_mixing(mesh, member_tpl, member_specs, mcfg,
                                       lids, total_layers(num_blocks), n)
        comm = static_shard_mix_comm(
            pplan, opt_state=opt_specs if isinstance(opt_specs, dict)
            else None)
        pop_local, opt_local = mix_collective_sharded(
            seed, pop_local, opt_local, mcfg, pplan, mesh, True)
        return pop_local, opt_local, float(n * comm)

    return mixer
