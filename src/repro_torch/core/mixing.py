"""Population mixing strategies on a stacked population.

Port of the stacked path of ``repro/core/mixing.py``.  After every
optimizer step the training loop calls :func:`mix_stacked` on the stacked
population.  Strategies:

  none      independent training (paper's Baseline)
  wash      parameter shuffling (paper Alg. 1)
  wash_opt  WASH + the same shuffle replayed on the optimizer moments
  papa      EMA pull toward consensus every T steps (PAPA, Eq. 1)
  papa_all  hard averaging every T_all steps (PAPA-all == DART)

Where the reference returns new trees, the port writes the stacked params
and moments **in place** (and returns them), so a full-width population
is never held twice.  There is no ``pallas_shuffle`` switch: the leaves'
device picks the shuffle kernel (``core.shuffle.apply_plan_stacked``).
Communication (scalars sent per member per mixing step) feeds the paper's
Table 1; :func:`static_mix_comm` gives it exactly in float64 from shapes.
The ``mix_collective*`` variants mix a population spread over the ranks
of the ensemble mesh (``launch/mesh.py``): WASH exchanges rows over a
ring of sends and receives, PAPA all-reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import shuffle as shf
from repro_torch.core.population import tree_leaves, tree_map
from repro_torch.core.schedules import active_window

Tree = Any


@dataclasses.dataclass(frozen=True)
class MixingConfig:
    kind: str = "wash"           # none | wash | wash_opt | papa | papa_all
    base_p: float = 0.001        # WASH base probability (first layer)
    schedule: str = "decreasing" # decreasing | constant | increasing (Eq. 6 / Tab. 4)
    mode: str = "dense"          # dense | bucketed (see core.shuffle)
    papa_alpha: float = 0.99     # PAPA EMA coefficient (Eq. 1)
    papa_every: int = 10         # PAPA all-reduce period T
    papa_all_every: int = 1000   # PAPA-all / DART averaging period
    start_step: int = 0          # Fig. 5b ablation window
    stop_step: Optional[int] = None

    def shuffles_optimizer(self) -> bool:
        return self.kind == "wash_opt"


def momentum_like_leaves(opt_state: Tree, params: Tree) -> Tree:
    """The slice of the optimizer state that WASH+Opt shuffles: the
    moments ``mu`` and (AdamW) ``nu``, each shaped like the params."""
    return {k: opt_state[k] for k in ("mu", "nu") if k in opt_state}


def _wash_step_stacked(seed: int, params: Tree, opt_state: Optional[Tree],
                       cfg: MixingConfig, layer_ids: Tree, total_layers: int):
    plan = shf.make_plan(seed, params, layer_ids, total_layers, cfg.base_p,
                         cfg.schedule, cfg.mode)
    n = tree_leaves(params)[0].shape[0]
    shf.apply_plan_stacked(plan, params, cfg.mode)
    comm = shf.plan_sent_scalars(plan, n, cfg.mode)
    if cfg.shuffles_optimizer() and opt_state is not None:
        for moments in momentum_like_leaves(opt_state, params).values():
            shf.apply_plan_stacked(plan, moments, cfg.mode)
            comm = comm + shf.plan_sent_scalars(plan, n, cfg.mode)
    return params, opt_state, comm


#: columns of a stacked leaf averaged at a time
CHUNK = 1 << 24


def _mean0(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The members' mean of a stacked leaf ``x`` (n, ...), as (1, ...) in
    its dtype; with a ``mesh`` (a :class:`repro_torch.launch.mesh.EnsMesh`)
    of world > 1, of the population whose rank-local block is ``x``.

    Sums are taken in float64 (over column chunks), all-reduced across
    ranks, divided by the population size and rounded once to the leaf's
    dtype: a float64 sum of a few float32 values is exact, so the mean
    does not depend on the order of the adds, and PAPA gives the same
    population on 1, 2 or 4 ranks.  (The reference takes ``jnp.mean`` /
    ``pmean`` in the leaf's dtype; the two agree within its rounding.)"""
    world = 1 if mesh is None else mesh.world
    flat = x.reshape(x.shape[0], -1)
    out = torch.empty((1, flat.shape[1]), dtype=x.dtype, device=x.device)
    for a in range(0, flat.shape[1], CHUNK):
        s = torch.sum(flat[:, a:a + CHUNK], dim=0, dtype=torch.float64)
        if world > 1:
            dist.all_reduce(s, group=mesh.group)
        out[0, a:a + CHUNK] = s / (x.shape[0] * world)
    return out.view((1,) + tuple(x.shape[1:]))


def _papa_pull_stacked(params: Tree, alpha: float) -> Tree:
    for x in tree_leaves(params):
        x.copy_(alpha * x + (1.0 - alpha) * _mean0(x))
    return params


def _average_stacked(params: Tree) -> Tree:
    for x in tree_leaves(params):
        x.copy_(_mean0(x).expand_as(x))
    return params


def mixing_due(step: int, cfg: MixingConfig) -> bool:
    """The period/window test, on the host."""
    if cfg.kind == "none" or not active_window(step, cfg.start_step, cfg.stop_step):
        return False
    if cfg.kind in ("wash", "wash_opt"):
        return True
    if cfg.kind == "papa":
        return step > 0 and step % cfg.papa_every == 0
    if cfg.kind == "papa_all":
        return step > 0 and step % cfg.papa_all_every == 0
    raise ValueError(f"unknown mixing kind {cfg.kind!r}")


def mix_once(seed: int, params: Tree, opt_state: Optional[Tree],
             cfg: MixingConfig, layer_ids: Tree, total_layers: int
             ) -> Tuple[Tree, Optional[Tree], Any]:
    """Apply the strategy's op unconditionally (period logic lives in
    :func:`mixing_due`), in place.  Returns ``(params, opt_state,
    scalars sent per member)``; the count is a float64 device tensor for
    dense WASH (data-dependent masks) and a Python float otherwise."""
    n = tree_leaves(params)[0].shape[0]
    d = sum(x.numel() // n for x in tree_leaves(params))
    if cfg.kind in ("wash", "wash_opt"):
        return _wash_step_stacked(seed, params, opt_state, cfg, layer_ids,
                                  total_layers)
    if cfg.kind == "papa":
        return _papa_pull_stacked(params, cfg.papa_alpha), opt_state, float(d)
    if cfg.kind == "papa_all":
        return _average_stacked(params), opt_state, float(d)
    return params, opt_state, 0.0


def mix_stacked(step: int, seed: int, params: Tree, opt_state: Optional[Tree],
                cfg: MixingConfig, layer_ids: Tree, total_layers: int
                ) -> Tuple[Tree, Optional[Tree], Any]:
    """:func:`mix_once` when :func:`mixing_due`, else nothing (0 sent)."""
    if not mixing_due(step, cfg):
        return params, opt_state, 0.0
    return mix_once(seed, params, opt_state, cfg, layer_ids, total_layers)


def static_mix_comm(member_params: Tree, cfg: MixingConfig, layer_ids: Tree,
                    total_layers: int, n: int,
                    opt_state: Optional[Tree] = None) -> Optional[float]:
    """Exact scalars sent per member on a mixing-due step, in float64 on
    the host.

    Bucketed plan sizes are a function of shapes, N and p alone
    (:func:`core.shuffle.bucketed_plan_sizes`), so ``member_params`` may be
    ``meta`` tensors.  Returns None when the count depends on the data
    (dense WASH draws Bernoulli masks); callers then take the count
    :func:`mix_once` reports."""
    if cfg.kind == "none":
        return 0.0
    if cfg.kind in ("papa", "papa_all"):
        return float(sum(x.numel() for x in tree_leaves(member_params)))
    if cfg.mode != "bucketed":
        return None
    sizes = shf.bucketed_plan_sizes(member_params, layer_ids, total_layers,
                                    cfg.base_p, cfg.schedule, n)
    sel = sum(n * k for k in sizes if k is not None)
    comm = sel * (n - 1) / n
    if cfg.shuffles_optimizer() and opt_state is not None:
        comm = comm * (1 + len(momentum_like_leaves(opt_state, member_params)))
    return comm


# ---------------------------------------------------------------------------
# collective variants (a block of members a rank of the ensemble mesh)
# ---------------------------------------------------------------------------


def _wash_collective(seed: int, params: Tree, opt_state: Optional[Tree],
                     cfg: MixingConfig, layer_ids: Tree, total_layers: int,
                     member: Tree, n: int, apply) -> float:
    """One bucketed plan from the shared seed, drawn for the population
    of ``n`` on the member template ``member`` (the same indices on every
    rank), applied in place to the params and, under WASH+Opt, replayed
    on the moments.  Returns the scalars each member sends."""
    plan = shf.make_plan(seed, member, layer_ids, total_layers, cfg.base_p,
                         cfg.schedule, mode="bucketed", n=n)
    apply(plan, params)
    comm = shf.plan_sent_scalars(plan, n, mode="bucketed")
    if cfg.shuffles_optimizer() and opt_state is not None:
        for moments in momentum_like_leaves(opt_state, params).values():
            apply(plan, moments)
            comm = comm + shf.plan_sent_scalars(plan, n, mode="bucketed")
    return comm


def mix_collective(step: int, seed: int, params: Tree,
                   opt_state: Optional[Tree], cfg: MixingConfig,
                   layer_ids: Tree, total_layers: int, mesh
                   ) -> Tuple[Tree, Optional[Tree], float]:
    """Mixing with one member a rank of ``mesh`` (leaves carry no ens
    axis), in place: WASH on the bucketed plan from the shared seed, its
    rows exchanged over the ring; PAPA and PAPA-all over an all-reduce.
    Returns ``(params, opt_state, scalars sent per member)``."""
    if cfg.kind == "none" or not active_window(step, cfg.start_step,
                                               cfg.stop_step):
        return params, opt_state, 0.0
    n = mesh.world
    if cfg.kind in ("wash", "wash_opt"):
        comm = _wash_collective(
            seed, params, opt_state, cfg, layer_ids, total_layers, params, n,
            lambda plan, tree: shf.apply_plan_collective(plan, tree, mesh))
        return params, opt_state, comm
    due = step > 0 and step % (cfg.papa_every if cfg.kind == "papa"
                               else cfg.papa_all_every) == 0
    if cfg.kind not in ("papa", "papa_all") or not due:
        return params, opt_state, 0.0
    for x in tree_leaves(params):
        mean = _mean0(x.unsqueeze(0), mesh)[0]
        x.copy_(cfg.papa_alpha * x + (1.0 - cfg.papa_alpha) * mean
                if cfg.kind == "papa" else mean)
    return params, opt_state, float(sum(x.numel()
                                        for x in tree_leaves(params)))


def mix_collective_blocked(seed: int, params: Tree, opt_state: Optional[Tree],
                           cfg: MixingConfig, layer_ids: Tree,
                           total_layers: int, mesh, gate: bool
                           ) -> Tuple[Tree, Optional[Tree]]:
    """The ensemble engine's mixing on this rank's block of members
    (leaves ``(n_local, ...)``; the population is n_local x world), in
    place.

    ``gate`` is the host's :func:`mixing_due` for the step: a closed gate
    mixes nothing, as the reference's ``where(gate > 0, ...)`` keeps the
    old values.  The WASH plan is drawn once from the shared seed on the
    member template (``block[0]``) with the global n, so every rank draws
    the same indices, and replayed on the moments under WASH+Opt.  PAPA
    pulls toward the population's mean (all-reduced); PAPA-all sets
    every member to it (:func:`_mean0`: the same on any world size).
    Comm is counted on the host from
    :func:`static_mix_comm`, as in the reference."""
    if cfg.kind == "none" or not gate:
        return params, opt_state
    if cfg.kind in ("wash", "wash_opt"):
        n = tree_leaves(params)[0].shape[0] * mesh.world
        member = tree_map(lambda x: x[0], params)
        _wash_collective(
            seed, params, opt_state, cfg, layer_ids, total_layers, member, n,
            lambda plan, tree: shf.apply_plan_collective_blocked(plan, tree,
                                                                 mesh))
        return params, opt_state
    return papa_blocked(params, cfg, mesh), opt_state


def papa_blocked(params: Tree, cfg: MixingConfig, mesh) -> Tree:
    """PAPA's pull (PAPA-all's average) of this rank's block of members
    toward the population's mean over ``mesh``'s group (:func:`_mean0`),
    in place.  Elementwise, so a block of member shards mixes exactly as
    the whole members would."""
    if cfg.kind not in ("papa", "papa_all"):
        raise ValueError(f"unknown mixing kind {cfg.kind!r}")
    for x in tree_leaves(params):
        mean = _mean0(x, mesh)
        if cfg.kind == "papa":
            x.copy_(cfg.papa_alpha * x + (1.0 - cfg.papa_alpha) * mean)
        else:
            x.copy_(mean.expand_as(x))
    return params
