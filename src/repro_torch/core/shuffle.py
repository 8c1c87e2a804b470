"""Parameter shuffling — the core mechanism of WASH (paper Eq. 3).

Port of the stacked parts of ``repro/core/shuffle.py``.  Two modes, equal
in expectation (Eq. 4) and both exactly distance-preserving (Eq. 5):

``dense``    every scalar coordinate draws an independent uniform
             permutation of {0..N-1} (argsort of per-scalar uniforms over
             the ens axis) gated by an independent Bernoulli(p_l).
``bucketed`` exactly k_l = round(p_l * d_l) coordinates per leaf, chosen by
             stratified sampling (unique, shared randomness) and split
             into N equal buckets; bucket s applies the cyclic shift
             π(n) = (n+s) mod N, bucket 0 the identity, so each member
             sends k_l (N-1)/N scalars per leaf per step.

Shuffles are *plans* (trees of index tensors) built once per step from a
shared seed, so WASH+Opt replays the identical plan on the optimizer
moments.  A plan tree mirrors the params: each leaf is None (nothing
moves), a bucketed ``(N, k_per)`` int32 index tensor, or a dense
``(perm, mask)`` pair, which tree functions treat as one leaf.

Randomness comes from integer seeds (``core.prng``), not ``jax.random``:
the port's plans hold the reference's contracts but not its numbers.
:func:`apply_plan_stacked` picks the kernel by device, with no flag: a
CUDA leaf goes to the hand-written Hopper kernels (a tree's dense leaves
together, in place), a CPU leaf to their plain versions.  The ``*_collective*`` applies run the same plans on a
block of members per rank of the ensemble mesh (``launch/mesh.py``),
rows crossing ranks over a ring of ``torch.distributed`` sends and
receives where the reference ``ppermute``s.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core.device import resolve_device
from repro_torch.core.population import tree_leaves, tree_map
from repro_torch.core.prng import fold_in, generator, leaf_seed
from repro_torch.core.schedules import layer_probability, layer_probability_array
from repro_torch.kernels import ops

Tree = Any

_INT32_MAX = 2 ** 31 - 1


def _is_plan_leaf(x) -> bool:
    return x is None or isinstance(x, tuple)


# ---------------------------------------------------------------------------
# dense (faithful) mode
# ---------------------------------------------------------------------------


def _perm_and_uniforms(seed: int, shape, n: int, device):
    u = torch.rand((n,) + tuple(shape),
                   generator=generator(fold_in(seed, 0), device), device=device)
    perm = torch.argsort(u, dim=0).to(torch.int32)
    del u
    gate = torch.rand(tuple(shape), generator=generator(fold_in(seed, 1), device),
                      device=device)
    return perm, gate


def dense_plan(seed: int, shape, n: int, p_l: float, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate uniform permutation + Bernoulli gate for one leaf.

    ``shape`` is the *member* shape (without the ens axis).  Returns
    ``(perm, mask)``: ``perm`` (n, *shape) int32 whose columns are
    independent uniform permutations of range(n), ``mask`` shape bool."""
    perm, gate = _perm_and_uniforms(seed, shape, n, resolve_device(device))
    return perm, gate < p_l


def dense_plan_layered(seed: int, shape, n: int, p_vec, device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense plan for a stacked-blocks leaf of member shape (L, *rest):
    layer l's coordinates are gated with ``p_vec[l]``, so Eq. 6 stays exact
    with all blocks in one leaf."""
    device = resolve_device(device)
    perm, gate = _perm_and_uniforms(seed, shape, n, device)
    p = torch.as_tensor(np.asarray(p_vec, np.float32), device=device)
    return perm, gate < p.reshape((shape[0],) + (1,) * (len(shape) - 1))


def dense_apply(leaf: torch.Tensor, perm: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """θ̂_n^i = θ_{π_i(n)}^i where masked, else θ_n^i (leaf: (n, *shape));
    a new tensor, through ``ops.wash_shuffle``."""
    n = leaf.shape[0]
    out = ops.wash_shuffle(leaf.reshape(n, -1), perm.reshape(n, -1),
                           mask.reshape(-1))
    return out.reshape(leaf.shape)


# ---------------------------------------------------------------------------
# bucketed mode
# ---------------------------------------------------------------------------


def stratified_unique_indices(seed: int, d: int, k: int, device="cuda"
                              ) -> torch.Tensor:
    """k unique int32 indices in [0, d), one uniform draw per equal stratum,
    in ascending order (the strata are).

    Strata bounds are computed in int64 (the reference computes
    ``i * d`` in int32, which wraps once ``i * d`` passes 2**31; ROADMAP
    §3)."""
    device = resolve_device(device)
    if k <= 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    if d > _INT32_MAX:
        raise ValueError(f"leaf of {d} scalars per member: int32 plans "
                         f"address at most {_INT32_MAX}")
    i = torch.arange(k, dtype=torch.int64, device=device)
    starts = (i * d) // k
    widths = torch.clamp((i + 1) * d // k - starts, min=1)
    offs = torch.randint(0, _INT32_MAX, (k,), generator=generator(
        fold_in(seed, 0), device), device=device) % widths
    return (starts + offs).to(torch.int32)


def _deal_rows(seed: int, pool: torch.Tensor, n: int) -> Optional[torch.Tensor]:
    """Deal an ascending pool of unique coordinates into ``(n, k_per)``
    rows, ``k_per = len(pool) // n``: as a uniformly random permutation of
    the pool cut into rows would (each row a uniformly random subset, the
    rows disjoint, the ``len(pool) - n * k_per`` left over dropped at
    random), but every row stays in the pool's ascending order, so the
    shuffle kernel's neighbouring threads touch neighbouring columns.

    Balanced random labels (row j // k_per for the pool entry at place j
    of a random permutation; n marks a dropped entry), then each row
    compacted in pool order by one scatter.  An entry's slot is the
    running count of the (row, entry) one-hot flattened row after row:
    every row holds k_per labels, so in row s that count is s * k_per plus
    the entry's place in its row.  One flat scan (a scan along each of n
    rows is many times slower on the card), no sort, no host sync."""
    device = pool.device
    total = pool.shape[0]
    k_per = total // n
    if k_per == 0:
        return None
    order = torch.randperm(total, generator=generator(seed, device),
                           device=device)
    label = torch.empty(total, dtype=torch.int64, device=device)
    label[order] = torch.clamp(
        torch.arange(total, device=device) // k_per, max=n)
    onehot = label[None, :] == torch.arange(n, device=device)[:, None]
    slot = torch.cumsum(onehot.view(-1), 0, dtype=torch.int32).view(n, total)
    slot = slot.gather(0, torch.clamp(label, max=n - 1)[None])[0].long() - 1
    dest = torch.where(label < n, slot, n * k_per)
    out = torch.empty(n * k_per + 1, dtype=pool.dtype, device=device)
    out.scatter_(0, dest, pool)  # dropped entries all land in the last slot
    return out[:n * k_per].view(n, k_per)


def bucket_count(d: int, n: int, p_l: float) -> int:
    """Per-bucket coordinate count k_per; total selected = k_per * n."""
    k = int(round(p_l * d))
    return max(k // n, 0)


def bucketed_plan(seed: int, d: int, n: int, p_l: float,
                  k_per: Optional[int] = None, device="cuda"
                  ) -> Optional[torch.Tensor]:
    """Index plan ``(n, k_per)`` int32; row s holds coordinates shifted by
    s, in ascending order.  None when the leaf is too small or the
    probability too low for one coordinate per bucket."""
    if k_per is None:
        k_per = bucket_count(d, n, p_l)
    if k_per == 0:
        return None
    pool = stratified_unique_indices(seed, d, k_per * n, device)
    return _deal_rows(fold_in(seed, 1), pool, n)


def layered_counts(num_layers: int, d_rest: int, p_vec,
                   counts: Optional[Sequence[int]] = None) -> List[int]:
    """Coordinates each layer of a stacked-blocks leaf contributes:
    round(p_l * d_rest), at most d_rest (``counts`` overrides the
    rounding)."""
    if counts is None:
        counts = [int(round(float(p_vec[l]) * d_rest)) for l in range(num_layers)]
    return [min(int(k), d_rest) if int(k) > 0 else 0 for k in counts]


def bucketed_plan_layered(seed: int, num_layers: int, d_rest: int, n: int,
                          p_vec, counts: Optional[Sequence[int]] = None,
                          device="cuda") -> Optional[torch.Tensor]:
    """Bucketed plan for a stacked-blocks leaf of member shape (L, d_rest).

    Layer l contributes its :func:`layered_counts` coordinates inside its
    own flat range [l*d_rest, (l+1)*d_rest), so the pooled set keeps
    Eq. 6's depth profile; the pool (ascending, layer after layer) is
    dealt into N random rows of k_per, each in ascending order, the
    remainder of N dropped at random (:func:`_deal_rows`)."""
    if num_layers * d_rest > _INT32_MAX:
        raise ValueError(f"leaf of {num_layers * d_rest} scalars per member: "
                         f"int32 plans address at most {_INT32_MAX}")
    device = resolve_device(device)
    pieces = []
    for l, k_l in enumerate(layered_counts(num_layers, d_rest, p_vec, counts)):
        if k_l <= 0:
            continue
        pieces.append(stratified_unique_indices(fold_in(seed, l), d_rest, k_l,
                                                device) + l * d_rest)
    if not pieces:
        return None
    return _deal_rows(fold_in(seed, num_layers + 1), torch.cat(pieces), n)


def bucketed_apply_stacked(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Apply a bucketed plan to a stacked leaf (n, *shape); a new tensor,
    through ``ops.bucketed_shuffle``."""
    n = leaf.shape[0]
    return ops.bucketed_shuffle(leaf.reshape(n, -1), idx).reshape(leaf.shape)


def _block_from(vals: torch.Tensor, mesh, q: int) -> torch.Tensor:
    """This rank's copy of the block held q ranks ahead on the ring: each
    rank sends ``vals`` to (rank - q) mod m and receives from (rank + q)
    mod m, both posted at once (the reference's ``ppermute`` with
    ``perm=[(j, (j - q) % m)]``).  At q mod m == 0, ``vals`` itself."""
    m = mesh.world
    if q % m == 0:
        return vals
    send = vals.contiguous()
    recv = torch.empty_like(send)
    coll.exchange([("send", send, mesh.global_rank((mesh.rank - q) % m)),
                   ("recv", recv, mesh.global_rank((mesh.rank + q) % m))],
                  mesh.group)
    return recv


def bucketed_apply_collective(x_flat: torch.Tensor, idx: torch.Tensor,
                              mesh) -> torch.Tensor:
    """Apply a bucketed plan to one member's flat params (D,), one member
    a rank, **in place**.  Bucket s is one exchange: member j sends its
    k_per selected scalars to member (j - s) mod N, so each member sends
    k_per (N - 1) scalars a step, the paper's p·d·(N-1)/N."""
    for s in range(1, mesh.world):
        cols = idx[s].long()
        x_flat.index_copy_(0, cols, _block_from(x_flat.index_select(0, cols),
                                                mesh, s))
    return x_flat


def bucketed_apply_collective_blocked(x_flat: torch.Tensor,
                                      idx: torch.Tensor, mesh) -> torch.Tensor:
    """Bucketed apply for a rank holding ``n_local`` contiguous members,
    ``x_flat`` (n_local, D), **in place**; the population is n = n_local m.

    Bucket s applies the global cyclic shift θ̂_g = θ_{(g+s) mod n}.  For
    member i of rank j (g = j n_local + i) the source rows [g+s, g+s+n_local)
    span at most two neighbouring ranks, so a bucket costs at most two
    exchanges whatever n_local is; at m == 1 it is the stacked roll."""
    n_local = x_flat.shape[0]
    for s in range(1, n_local * mesh.world):
        cols = idx[s].long()
        vals = x_flat.index_select(1, cols)          # (n_local, k_per)
        q, r = divmod(s, n_local)
        shifted = _block_from(vals, mesh, q)
        if r:
            shifted = torch.cat([shifted, _block_from(vals, mesh, q + 1)]
                                )[r:r + n_local]
        x_flat.index_copy_(1, cols, shifted)
    return x_flat


# ---------------------------------------------------------------------------
# tree-level plans
# ---------------------------------------------------------------------------


def _leaf_schedule(member_shape, lid, total_layers: int, base_p: float,
                   schedule: str):
    """``(None, None)`` when the leaf gets no plan, else ``("layered",
    p_vec)`` for a stacked-blocks leaf or ``("flat", p_l)``."""
    if not isinstance(lid, (int, np.integer)):
        p_vec = np.clip(layer_probability_array(base_p, lid, total_layers,
                                                schedule), 0.0, 1.0)
        if p_vec.max() <= 0.0:
            return None, None
        if not (len(member_shape) and len(p_vec) == member_shape[0]):
            raise ValueError(f"layered lid len {len(p_vec)} vs leaf "
                             f"{tuple(member_shape)}")
        return "layered", p_vec
    p_l = layer_probability(base_p, int(lid), total_layers, schedule)
    if p_l <= 0.0:
        return None, None
    return "flat", min(p_l, 1.0)


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


def make_plan(seed: int, params: Tree, layer_ids: Tree, total_layers: int,
              base_p: float, schedule: str = "decreasing", mode: str = "dense",
              n: Optional[int] = None, device=None) -> Tree:
    """Build a shuffle plan for a whole (stacked) population tree.

    ``params`` is the stacked population (leading ens axis) or, with
    explicit ``n``, a single member template.  Leaf i draws from
    ``leaf_seed(seed, i)``.  The plan lands on ``device``, by default each
    leaf's own device."""
    if mode not in ("dense", "bucketed"):
        raise ValueError(f"unknown shuffle mode {mode!r}")
    plans = []
    for i, (leaf, lid) in enumerate(zip(tree_leaves(params),
                                        tree_leaves(layer_ids))):
        k = leaf_seed(seed, i)
        if n is None:
            nn, member_shape = int(leaf.shape[0]), tuple(leaf.shape[1:])
        else:
            nn, member_shape = n, tuple(leaf.shape)
        dev = leaf.device if device is None else device
        kind, p = _leaf_schedule(member_shape, lid, total_layers, base_p,
                                 schedule)
        if kind is None:
            plans.append(None)
        elif mode == "dense":
            build = dense_plan_layered if kind == "layered" else dense_plan
            plans.append(build(k, member_shape, nn, p, dev))
        elif kind == "layered":
            plans.append(bucketed_plan_layered(
                k, member_shape[0], _numel(member_shape[1:]), nn, p,
                device=dev))
        else:
            plans.append(bucketed_plan(k, _numel(member_shape), nn, p,
                                       device=dev))
    it = iter(plans)
    return tree_map(lambda _: next(it), params)


def bucketed_plan_sizes(member_params: Tree, layer_ids: Tree,
                        total_layers: int, base_p: float,
                        schedule: str, n: int) -> List[Optional[int]]:
    """``k_per`` of each leaf's bucketed plan (None: no plan), in leaf
    order, from the shapes alone: what :func:`make_plan` would build,
    without drawing it.  ``member_params`` may hold ``meta`` tensors."""
    sizes: List[Optional[int]] = []
    for leaf, lid in zip(tree_leaves(member_params), tree_leaves(layer_ids)):
        shape = tuple(leaf.shape)
        kind, p = _leaf_schedule(shape, lid, total_layers, base_p, schedule)
        if kind is None:
            k_per = 0
        elif kind == "layered":
            k_per = sum(layered_counts(shape[0], _numel(shape[1:]), p)) // n
        else:
            k_per = bucket_count(_numel(shape), n, p)
        sizes.append(k_per if k_per > 0 else None)
    return sizes


def apply_plan_stacked(plan: Tree, tree: Tree, mode: str = "dense") -> Tree:
    """Apply a plan to a stacked tree (params, or optimizer moments),
    **in place**: each planned leaf (contiguous, leading ens axis) is
    shuffled where it lies, and the tree is returned.

    The leaves' device picks the kernel: ``ops.bucketed_shuffle_`` (sparse,
    in place) a leaf for bucketed plans; for dense ones every planned
    leaf goes in one ``ops.wash_shuffle_many_`` call (in place, one launch
    a word size on the card)."""
    dense: Tuple[list, list, list] = ([], [], [])

    def _one(p, leaf):
        if p is None:
            return leaf
        n = leaf.shape[0]
        flat = leaf.view(n, -1)
        if mode == "dense":
            perm, mask = p
            for group, t in zip(dense, (flat, perm.reshape(n, -1),
                                        mask.reshape(-1))):
                group.append(t)
        else:
            ops.bucketed_shuffle_(flat, p)
        return leaf

    out = tree_map(_one, plan, tree, is_leaf=_is_plan_leaf)
    if dense[0]:
        ops.wash_shuffle_many_(*dense)
    return out


def apply_plan_collective(plan: Tree, tree: Tree, mesh) -> Tree:
    """Apply a bucketed plan to one member's tree, one member a rank of
    ``mesh``, **in place** (every leaf contiguous)."""

    def _one(p, leaf):
        if p is not None:
            bucketed_apply_collective(leaf.view(-1), p, mesh)
        return leaf

    return tree_map(_one, plan, tree, is_leaf=_is_plan_leaf)


def apply_plan_collective_blocked(plan: Tree, tree: Tree, mesh) -> Tree:
    """Apply a bucketed plan, drawn for the whole population, to this
    rank's block of members (leaves ``(n_local, *member_shape)``,
    contiguous), **in place**.  At world 1 each planned leaf goes whole
    through ``ops.bucketed_shuffle_`` (the CUDA kernel on the card: the
    reference's Pallas route when the ens axis is one shard); across
    ranks the rows travel by :func:`bucketed_apply_collective_blocked`."""

    def _one(p, leaf):
        if p is None:
            return leaf
        flat = leaf.view(leaf.shape[0], -1)
        if mesh.world == 1:
            ops.bucketed_shuffle_(flat, p)
        else:
            bucketed_apply_collective_blocked(flat, p, mesh)
        return leaf

    return tree_map(_one, plan, tree, is_leaf=_is_plan_leaf)


# ---------------------------------------------------------------------------
# communication accounting (paper Table 1)
# ---------------------------------------------------------------------------


def plan_selected_scalars(plan: Tree, mode: str = "dense"):
    """Scalars *selected* for shuffling this step (the paper's p·d): an int
    for bucketed plans, an int64 device tensor (the masks' count) for
    dense ones."""
    total = 0
    for p in tree_leaves(plan, is_leaf=_is_plan_leaf):
        if p is None:
            continue
        if mode == "dense":
            total = total + p[1].sum()
        else:
            total = total + p.numel()
    return total


def plan_sent_scalars(plan: Tree, n: int, mode: str = "dense"):
    """Scalars actually *sent* per member (identity assignments excluded),
    in float64: a Python float for bucketed plans, a device tensor for
    dense ones.  (The reference's dense count is float32, which rounds
    past 2**24 and, under XLA, divides by N through its reciprocal; the
    two agree within float32 rounding.)"""
    sel = plan_selected_scalars(plan, mode)
    if torch.is_tensor(sel):
        sel = sel.double()
    return sel * (n - 1) / n
