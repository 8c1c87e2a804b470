"""Mixture-of-Experts layer: top-k router and static-capacity sort dispatch.

Port of ``repro/models/moe.py``.  The dispatch is the reference's
GShard-style static-capacity form: each token's top-k (expert, weight)
assignments are sorted by expert id, each expert takes a fixed buffer of
``capacity`` rows, and assignments past it are dropped (the token keeps
its residual path).  Every shape is fixed by the config and the token
count: no data-dependent shape and no host sync in the dispatch (a stable
``argsort``, a scatter into a fixed ``(G, E * C, D)`` buffer, three
batched expert products, a gather back).

Dispatch runs over G token groups: ``cfg.moe_impl == "global"`` is one
group of all B·T tokens, ``"grouped"`` one group per batch row (B > 1).
The reference also pins the buffer's layout with
``repro.sharding.hints.constrain``, an identity while sharding hints are
off; the port has no sharding yet, so those calls are dropped.

Deterministic on the card: a kept assignment owns its buffer row alone
(dropped ones go to a spare row that is sliced away), and a token's k
expert outputs are summed in a fixed order (ascending expert id, the
order the reference's scatter-add visits them), never by an accumulating
scatter.  The router stays float32 in a bf16 model, as in the reference.

Shared experts (DeepSeek-V2 / Kimi-K2 style) run densely on every token.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, param_dtype, swiglu,
                                       swiglu_init)

_EXPERT_SHAPES = ("w1", "w3", "w2")


def moe_init(gen: torch.Generator, cfg: ModelConfig, lead=(),
             experts: Optional[dict] = None):
    """The reference's MoE tree with ``lead`` stacked axes (layers): the
    float32 router, the experts' ``w1``/``w3`` (E, D, F) and ``w2``
    (E, F, D), and the shared experts' SwiGLU.  Expert weights are drawn
    one leading index (layer) at a time, so a full-width draw never holds
    a whole expert leaf in float32; ``experts`` optionally gives the three
    destination tensors (views of a stacked population, for instance),
    which are filled in place and returned in the tree."""
    dtype = param_dtype(cfg)
    E, D, Fd = cfg.n_routed_experts, cfg.d_model, cfg.resolved_moe_d_ff
    lead = tuple(lead)
    shapes = {"w1": (E, D, Fd), "w3": (E, D, Fd), "w2": (E, Fd, D)}
    p = {"router": dense_init(gen, (D, E), torch.float32, lead=lead),
         "experts": {}}
    for name in _EXPERT_SHAPES:
        dst = (torch.empty(lead + shapes[name], dtype=dtype, device=gen.device)
               if experts is None else experts[name])
        for idx in itertools.product(*(range(n) for n in lead)):
            dst[idx].copy_(dense_init(gen, shapes[name], dtype))
        p["experts"][name] = dst
    if cfg.n_shared_experts > 0:
        p["shared"] = swiglu_init(gen, D, Fd * cfg.n_shared_experts, dtype,
                                  lead=lead)
    return p


def moe_shapes(cfg: ModelConfig, num_layers: int):
    """The stacked MoE tree as ``meta`` tensors (shapes and dtypes)."""
    dtype = param_dtype(cfg)
    E, D, Fd = cfg.n_routed_experts, cfg.d_model, cfg.resolved_moe_d_ff

    def m(*shape, dt=dtype):
        return torch.empty((num_layers,) + shape, dtype=dt, device="meta")

    p = {"router": m(D, E, dt=torch.float32),
         "experts": {"w1": m(E, D, Fd), "w3": m(E, D, Fd), "w2": m(E, Fd, D)}}
    if cfg.n_shared_experts > 0:
        Fs = Fd * cfg.n_shared_experts
        p["shared"] = {"w1": m(D, Fs), "w3": m(D, Fs), "w2": m(Fs, D)}
    return p


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Rows an expert takes from a group of ``num_tokens`` tokens: at least
    8, rounded up to a multiple of 8."""
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_routed_experts)
    return max(8, -(-c // 8) * 8)


def moe_apply(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux loss); the caller adds the residual."""
    B, T, D = x.shape
    if cfg.moe_impl == "grouped" and B > 1:
        xg = x
    else:
        xg = x.reshape(1, B * T, D)
    out, aux = _dispatch_grouped(p, cfg, xg)
    out = out.reshape(B, T, D)
    if cfg.n_shared_experts > 0:
        out = out + swiglu(p["shared"], x.reshape(B * T, D)).reshape(B, T, D)
    return out, aux


def _dispatch_grouped(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """x: (G, Tg, D) token groups -> (out (G, Tg, D), aux)."""
    G, Tg, D = x.shape
    E, K = cfg.n_routed_experts, cfg.top_k
    C = capacity(cfg, Tg)
    TK = Tg * K
    dev = x.device

    logits = x.float() @ p["router"]                     # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)           # (G, Tg, K)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # Switch-style load-balance auxiliary loss (over all tokens); adding
    # equal values, the scatter-add's order cannot change the sum
    me = torch.mean(probs, dim=(0, 1))
    first = top_i[..., 0].reshape(-1)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, first, torch.full(first.shape, 1.0 / (G * Tg),
                             dtype=torch.float32, device=dev))
    aux = E * torch.sum(me * ce)

    # a token's k assignments in ascending expert order: the stable sort
    # by expert below then orders every expert's rows by token, as the
    # reference's, and the combine sums a token's outputs in that order
    top_i, perm = torch.sort(top_i, dim=-1)
    top_w = torch.gather(top_w, -1, perm)
    flat_e = top_i.reshape(G, TK)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)[None]
    flat_t = flat_t.expand(G, TK)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(top_w.reshape(G, TK), 1, order)

    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add_(
        1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(TK, device=dev)[None]
                - torch.gather(starts, 1, se))
    keep = pos_in_e < C
    slot = se * C + torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e))

    # dispatch: a kept assignment owns its row; dropped ones land on the
    # spare row E * C, which is sliced away
    dst = torch.where(keep, slot, torch.full_like(slot, E * C))
    xt = torch.gather(x, 1, st[..., None].expand(G, TK, D))
    buf = x.new_zeros((G, E * C + 1, D)).scatter(
        1, dst[..., None].expand(G, TK, D), xt)
    buf = buf[:, :E * C].reshape(G, E, C, D)

    w = p["experts"]
    h = (F.silu(torch.einsum("gecd,edf->gecf", buf, w["w1"]))
         * torch.einsum("gecd,edf->gecf", buf, w["w3"]))
    out_buf = torch.einsum("gecf,efd->gecd", h, w["w2"]).reshape(G, E * C, D)

    contrib = torch.gather(out_buf, 1, slot[..., None].expand(G, TK, D))
    contrib = contrib * (sw * keep)[..., None].to(x.dtype)
    # back to (token, k) order, then a token's k outputs summed in order
    unsorted = torch.zeros_like(contrib).scatter(
        1, order[..., None].expand(G, TK, D), contrib).reshape(G, Tg, K, D)
    out = unsorted[:, :, 0]
    for k in range(1, K):
        out = out + unsorted[:, :, k]
    return out, aux
