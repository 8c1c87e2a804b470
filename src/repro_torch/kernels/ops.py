"""Public kernel entry points: the tensors' device picks the route.

Counterpart of ``repro/kernels/ops.py``.  Where the JAX package picks the
Pallas kernel by backend (``interpret=None``), here a CUDA tensor goes to
the hand-written Hopper kernel and a CPU tensor to the plain PyTorch
version.  There is no switch that turns the kernel off on the card and no
fallback from the kernel to the plain version: a CUDA call the kernel
cannot take raises.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes a third
route: empty outputs of the kernel's shapes and dtypes, and the
kernel's bytes and operations (``kernels/work.py``) reported to every
counter in :data:`work_counters` (``launch/op_stats.py`` pushes one for
a step it counts).  Nothing is computed and nothing is allocated.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import selective_scan as _ssm
from repro_torch.kernels import wash_shuffle as _ws
from repro_torch.kernels import work as _work
from repro_torch.kernels.ref import (bucketed_shuffle_ref_,
                                     flash_attention_ref,
                                     paged_attention_ref, rwkv6_scan_bwd_ref,
                                     rwkv6_scan_ref, selective_scan_bwd_ref,
                                     selective_scan_ref, wash_shuffle_many_ref_,
                                     wash_shuffle_ref)


#: callables ``(kernel, bytes, operations)`` that a meta route reports
#: its kernel's work to
work_counters: List[Callable[[str, int, int], None]] = []


def _route(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{what}: no route for device {t.device}")
    return t.device.type


def _report(kernel: str, work) -> None:
    nbytes, nops = work
    for count in work_counters:
        count(kernel, int(nbytes), int(nops))


def wash_shuffle(x: torch.Tensor, perm: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Dense WASH apply on a stacked leaf: x (N,D), perm (N,D) int32,
    mask (D,) bool -> a new (N,D) tensor with
    ``out[n,i] = x[perm[n,i], i]`` where ``mask[i]``, else ``x[n,i]``."""
    route = _route(x, "wash_shuffle")
    if route == "cuda":
        return _ws.wash_shuffle_cuda(x, perm, mask)
    if route == "meta":  # every column masked: the most it could move
        n, d = x.shape
        _report("wash_shuffle", (_work.shuffle_bytes_dense(
            n, d, x.element_size(), d), 0))
        return torch.empty_like(x)
    return wash_shuffle_ref(x, perm, mask)


def wash_shuffle_many_(xs: Sequence[torch.Tensor],
                       perms: Sequence[torch.Tensor],
                       masks: Sequence[torch.Tensor]):
    """Dense WASH apply on many stacked leaves **in place**: each
    ``xs[i]`` (N,D) takes :func:`wash_shuffle` of ``(xs[i], perms[i],
    masks[i])``; on the card one launch a word size for up to 64 leaves.
    Returns ``xs``."""
    if not xs:
        return xs
    route = _route(xs[0], "wash_shuffle_many_")
    if route == "cuda":
        return _ws.wash_shuffle_many_cuda_(xs, perms, masks)
    if route == "meta":  # every column masked: the most it could move
        _report("wash_shuffle", (sum(_work.shuffle_bytes_dense(
            x.shape[0], x.shape[1], x.element_size(), x.shape[1],
            in_place=True) for x in xs), 0))
        return xs
    return wash_shuffle_many_ref_(xs, perms, masks)


def bucketed_shuffle_(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bucketed WASH apply on a stacked leaf x (N,D), **in place**: bucket
    s of the (N,k_per) plan ``idx`` moves its columns by the cyclic shift
    ``x[n] <- x[(n+s) mod N]``.  Returns ``x``."""
    route = _route(x, "bucketed_shuffle")
    if route == "cuda":
        return _ws.bucketed_shuffle_cuda_(x, idx)
    if route == "meta":
        _report("bucketed_shuffle", (_work.shuffle_bytes_bucketed(
            x.shape[0], idx.shape[-1], x.element_size()), 0))
        return x
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
    route = _route(q, "paged_attention")
    if route == "cuda":
        return _pa.paged_attention_cuda(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale)
    if route == "meta":  # every slot at its table's full length
        B, H, hd = q.shape
        _report("paged_attention", _work.paged_work_most(
            B, H, k_pool.shape[2], hd, k_pool.shape[1], page_table.shape[1],
            q.element_size(), k_pool.element_size(), k_scale is not None))
        return torch.empty_like(q)
    return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                               k_scale, v_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Whole-sequence GQA self-attention: q (B,S,H,hd), k (B,S,KV,hd), v
    (B,S,KV,hd_v) -> (B,S,H,hd_v) in q's dtype, scaled by ``hd**-0.5``;
    causal and/or a sliding ``window``."""
    route = _route(q, "flash_attention")
    if route == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if route == "meta":
        B, S, H, hd = q.shape
        _report("flash_attention", _work.flash_work(
            B, S, H, k.shape[2], hd, q.element_size(), causal, window,
            v.shape[-1]))
        return q.new_empty((B, S, H, v.shape[-1]))
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def _rwkv6_scan_forward(r, k, v, w, u, state):
    route = _route(r, "rwkv6_scan")
    if route == "cuda":
        return _wkv.rwkv6_scan_cuda(r, k, v, w, u, state=state)
    if route == "meta":
        B, T, H, hd = r.shape
        _report("rwkv6_scan", _work.wkv_work(B, T, H, hd))
        y = torch.empty_like(r)
        return y if state is None else (y, torch.empty_like(state))
    return rwkv6_scan_ref(r, k, v, w, u, state=state)


def _grads_meta(kernel: str, work, inputs, state):
    """The meta route of a backward: the work reported, an empty gradient
    of each input's shape and dtype (None for an absent state)."""
    _report(kernel, work)
    return tuple(torch.empty_like(x) for x in inputs) + (
        None if state is None else torch.empty_like(state),)


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
        if r.device.type == "meta":
            B, T, H, hd = r.shape
            return _grads_meta("rwkv6_scan_bwd", _work.wkv_bwd_work(
                B, T, H, hd, state is not None), (r, k, v, w, u), state)
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
    route = _route(u, "selective_scan")
    if route == "cuda":
        return _ssm.selective_scan_cuda(u, dt, Bm, Cm, A, state=state)
    if route == "meta":
        B, T, DI = u.shape
        _report("selective_scan", _work.ssm_work(
            B, T, DI, A.shape[-1], state is not None))
        y = u.new_empty(u.shape, dtype=torch.float32)
        return y if state is None else (y, torch.empty_like(state))
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
        if u.device.type == "meta":
            B, T, DI = u.shape
            return _grads_meta("selective_scan_bwd", _work.ssm_work(
                B, T, DI, A.shape[-1], state is not None, backward=True),
                (u, dt, Bm, Cm, A), state)
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
