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
The ``mix_collective*`` variants wait for multi-device training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import shuffle as shf
from repro_torch.core.population import tree_leaves
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


def _mean0(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0, keepdim=True)


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
