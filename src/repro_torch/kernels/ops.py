"""Public kernel entry points: the tensors' device picks the route.

Counterpart of ``repro/kernels/ops.py``.  Where the JAX package picks the
Pallas kernel by backend (``interpret=None``), here a CUDA tensor goes to
the hand-written Hopper kernel and a CPU tensor to the plain PyTorch
version.  There is no switch that turns the kernel off on the card and no
fallback from the kernel to the plain version: a CUDA call the kernel
cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import selective_scan as _ssm
from repro_torch.kernels import wash_shuffle as _ws
from repro_torch.kernels.ref import (bucketed_shuffle_ref_,
                                     flash_attention_ref,
                                     paged_attention_ref, rwkv6_scan_bwd_ref,
                                     rwkv6_scan_ref, selective_scan_bwd_ref,
                                     selective_scan_ref, wash_shuffle_ref)


def _route(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no route for device {t.device}")
    return t.device.type


def wash_shuffle(x: torch.Tensor, perm: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Dense WASH apply on a stacked leaf: x (N,D), perm (N,D) int32,
    mask (D,) bool -> a new (N,D) tensor with
    ``out[n,i] = x[perm[n,i], i]`` where ``mask[i]``, else ``x[n,i]``."""
    if _route(x, "wash_shuffle") == "cuda":
        return _ws.wash_shuffle_cuda(x, perm, mask)
    return wash_shuffle_ref(x, perm, mask)


def bucketed_shuffle_(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bucketed WASH apply on a stacked leaf x (N,D), **in place**: bucket
    s of the (N,k_per) plan ``idx`` moves its columns by the cyclic shift
    ``x[n] <- x[(n+s) mod N]``.  Returns ``x``."""
    if _route(x, "bucketed_shuffle") == "cuda":
        return _ws.bucketed_shuffle_cuda_(x, idx)
    return bucketed_shuffle_ref_(x, idx)


def bucketed_shuffle(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's functional signature: :func:`bucketed_shuffle_` on
    a copy of ``x``."""
    return bucketed_shuffle_(x.clone(), idx)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token paged attention for a batch of serving slots.

    q (B,H,hd); k/v_pool (P,page_size,KV,hd); page_table (B,max_pages);
    lengths (B,); optional per-page int8 dequant scales k/v_scale (P,),
    both or neither.  Returns (B,H,hd) in q's dtype."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if _route(q, "paged_attention") == "cuda":
        return _pa.paged_attention_cuda(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale)
    return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                               k_scale, v_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Whole-sequence GQA self-attention: q (B,S,H,hd), k (B,S,KV,hd), v
    (B,S,KV,hd_v) -> (B,S,H,hd_v) in q's dtype, scaled by ``hd**-0.5``;
    causal and/or a sliding ``window``."""
    if _route(q, "flash_attention") == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def _rwkv6_scan_forward(r, k, v, w, u, state):
    if _route(r, "rwkv6_scan") == "cuda":
        return _wkv.rwkv6_scan_cuda(r, k, v, w, u, state=state)
    return rwkv6_scan_ref(r, k, v, w, u, state=state)


class _RWKV6Scan(torch.autograd.Function):
    """The WKV recurrence with its gradient: the forward's route, and a
    backward on the same device's route (the CUDA backward kernel, or the
    plain reverse recurrence for CPU tensors).  The forward saves only its
    inputs; the backward recomputes the states it needs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _rwkv6_scan_forward(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, dstate_final=None):
        r, k, v, w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        fn = (_wkv.rwkv6_scan_bwd_cuda if r.device.type == "cuda"
              else rwkv6_scan_bwd_ref)
        return fn(r, k, v, w, u, state, dy.contiguous(),
                  None if dstate_final is None else dstate_final.contiguous())


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None):
    """RWKV-6 WKV recurrence: r/k/v/w (B,T,H,hd), u (H,hd) -> y (B,T,H,hd);
    with an initial ``state`` (B,H,hd,hd) float32, ``(y, final_state)``.

    Differentiable: where autograd records (grad mode on and an input that
    requires a grad), the gradient is the backward kernel on the card and
    the plain reverse recurrence on the CPU, float32 only (a bf16 input
    that needs a grad raises).  Otherwise the call is the forward alone."""
    xs = (r, k, v, w, u) + (() if state is None else (state,))
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return _rwkv6_scan_forward(r, k, v, w, u, state)
    if any(x.dtype != torch.float32 for x in xs):
        raise ValueError("rwkv6_scan: the gradient takes float32 inputs "
                         f"only, got {sorted({str(x.dtype) for x in xs})}")
    return _RWKV6Scan.apply(r, k, v, w, u, state)


def _selective_scan_forward(u, dt, Bm, Cm, A, state):
    if _route(u, "selective_scan") == "cuda":
        return _ssm.selective_scan_cuda(u, dt, Bm, Cm, A, state=state)
    return selective_scan_ref(u, dt, Bm, Cm, A, state=state)


class _SelectiveScan(torch.autograd.Function):
    """The selective-scan recurrence with its gradient: the forward's
    route, and a backward on the same device's route (the CUDA backward
    kernel, or the plain reverse recurrence for CPU tensors).  The forward
    saves only its inputs; the backward recomputes the states it needs."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, Bm, Cm, A, state)
        return _selective_scan_forward(u, dt, Bm, Cm, A, state)

    @staticmethod
    def backward(ctx, dy, dstate_final=None):
        u, dt, Bm, Cm, A, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        fn = (_ssm.selective_scan_bwd_cuda if u.device.type == "cuda"
              else selective_scan_bwd_ref)
        return fn(u, dt, Bm, Cm, A, state, dy.contiguous(),
                  None if dstate_final is None else dstate_final.contiguous())


def selective_scan(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Selective-scan (Mamba) recurrence: u/dt (B,T,DI), Bm/Cm (B,T,S),
    A (DI,S) -> y (B,T,DI) float32; with an initial ``state`` (B,DI,S)
    float32, ``(y, final_state)``.

    Differentiable: where autograd records (grad mode on and an input that
    requires a grad), the gradient is the backward kernel on the card and
    the plain reverse recurrence on the CPU, float32 only (an input of
    another dtype that needs a grad raises).  Otherwise the call is the
    forward alone."""
    xs = (u, dt, Bm, Cm, A) + (() if state is None else (state,))
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return _selective_scan_forward(u, dt, Bm, Cm, A, state)
    if any(x.dtype != torch.float32 for x in xs):
        raise ValueError("selective_scan: the gradient takes float32 inputs "
                         f"only, got {sorted({str(x.dtype) for x in xs})}")
    return _SelectiveScan.apply(u, dt, Bm, Cm, A, state)
