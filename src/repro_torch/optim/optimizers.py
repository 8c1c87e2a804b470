"""SGD+momentum (the paper's optimizer) and AdamW, plus cosine annealing.

Port of ``repro/optim/optimizers.py``: float32 moments, the same float32
arithmetic in the same order, and the result cast back to the parameter's
dtype.  Where the reference returns new trees, the updates here write the
parameters, the moments and the step counter **in place** and return them.
They go leaf by leaf and, within a leaf, over flat chunks of
:data:`CHUNK` elements, so the float32 temporaries of one chunk exist at a
time, not those of the tree (an elementwise update gives the same numbers
chunked or not).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.population import tree_leaves, tree_map

Tree = Any

#: elements of a leaf updated at a time
CHUNK = 1 << 24


def _zeros_like_f32(tree: Tree) -> Tree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _chunks(p: torch.Tensor, g: torch.Tensor, *moments: torch.Tensor
            ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat chunks of a parameter, its gradient and its moments.
    The parameter and the moments are written in place through the
    chunks, so they must be contiguous (``view`` raises otherwise)."""
    flats = [p.view(-1), g.reshape(-1), *(m.view(-1) for m in moments)]
    for a in range(0, flats[0].numel(), CHUNK):
        yield tuple(f[a:a + CHUNK] for f in flats)


# ---------------------------------------------------------------------------
# SGD with momentum + decoupled weight decay (paper §4: SGD, momentum, wd 1e-4)
# ---------------------------------------------------------------------------


def sgd_init(params: Tree) -> dict:
    return {"mu": _zeros_like_f32(params), "step": _step0(params)}


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, state: dict, lr,
               momentum: float = 0.9, weight_decay: float = 1e-4
               ) -> Tuple[Tree, dict]:
    for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                       tree_leaves(state["mu"])):
        for pc, gc, mc in _chunks(p, g, m):
            gf = gc.float() + weight_decay * pc.float()
            mc.mul_(momentum).add_(gf)                 # m = momentum*m + gf
            pc.copy_(pc.float() - lr * mc)             # cast to p's dtype
    state["step"] += 1
    return params, state


# ---------------------------------------------------------------------------
# AdamW (for the LLM examples; WASH+Opt shuffles both moments)
# ---------------------------------------------------------------------------


def adamw_init(params: Tree) -> dict:
    return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params),
            "step": _step0(params)}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: dict, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, dict]:
    state["step"] += 1
    step = state["step"].float()
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        for pc, gc, mc, vc in _chunks(p, g, m, v):
            gf = gc.float()
            mc.mul_(b1).add_((1 - b1) * gf)            # m = b1*m + (1-b1)*g
            vc.mul_(b2).add_((1 - b2) * gf * gf)       # v = b2*v + (1-b2)*g*g
            update = ((mc / c1) / (torch.sqrt(vc / c2) + eps)
                      + weight_decay * pc.float())
            pc.copy_(pc.float() - lr * update)
    return params, state


# ---------------------------------------------------------------------------
# schedules / factory
# ---------------------------------------------------------------------------


def cosine_lr(step, total_steps: int, base_lr: float, min_lr: float,
              warmup: int = 0) -> float:
    """Cosine annealing with optional linear warmup (paper: 0.1 -> 1e-4),
    in float32 as the reference computes it; returned as a Python float."""
    f = np.float32
    s = f(step)
    if s < warmup:
        return float(f(base_lr) * s / f(max(warmup, 1)))
    frac = np.clip((s - f(warmup)) / f(max(total_steps - warmup, 1)),
                   f(0.0), f(1.0))
    return float(f(min_lr) + f(0.5 * (base_lr - min_lr))
                 * (f(1.0) + np.cos(f(np.pi) * frac)))


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    if name == "sgd":
        return sgd_init, lambda p, g, s, lr: sgd_update(
            p, g, s, lr, momentum=kw.get("momentum", 0.9),
            weight_decay=kw.get("weight_decay", 1e-4))
    if name == "adamw":
        return adamw_init, lambda p, g, s, lr: adamw_update(
            p, g, s, lr, weight_decay=kw.get("weight_decay", 0.1))
    raise ValueError(f"unknown optimizer {name!r}")
