"""Shared layers: norms, rope, the MLPs, GQA, cross-attention and MLA for
training and serving.

Port of ``repro/models/layers.py``: what training, the scan engine (the
contiguous ring KV cache, MLA's latent cache, whisper's encoder and
cross-attention) and continuous batching (the paged KV cache) run.
Plain functions over explicit parameter dicts, in the reference's layout
(linear weights ``(d_in, d_out)`` used as ``x @ w``).
Compute-sensitive reductions run in float32.

Where the reference returns new caches and pools (JAX donates them), the
stores here write into the preallocated tensors **in place** and return
the same objects; a per-layer view ``cache[l]`` is written through to the
stacked ``(L, ...)`` tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    """Normal init scaled by fan_in**-0.5 (``shape[0]``), drawn in float32
    on the generator's device.  ``lead`` prepends stacked axes (layers)
    that do not count toward the fan-in."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    s = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (x * s).to(dtype)


# ---------------------------------------------------------------------------
# norms, rope, MLP
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype: torch.dtype, lead: Tuple[int, ...] = (),
                 device=None):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: (T,) or (..., T) absolute positions.
    Split-half layout: the first and second halves of hd rotate as pairs."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    pos = positions.float()
    ang = pos[..., :, None] * inv[None, :]  # (..., T, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., T, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen, d_model, d_ff, dtype, lead=()):
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w3": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w2": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
    }


def swiglu(p, x):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def gelu_mlp_init(gen, d_model, d_ff, dtype, lead=()):
    zeros = lambda n: torch.zeros(tuple(lead) + (n,), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "b1": zeros(d_ff),
        "w2": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
        "b2": zeros(d_model),
    }


def gelu_mlp(p, x):
    """The encoder's MLP.  ``jax.nn.gelu`` defaults to the tanh
    approximation, and so does this (the exact erf form differs by ~1e-3)."""
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg: ModelConfig, lead=()):
    dtype = param_dtype(cfg)
    hd = cfg.resolved_head_dim
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (D, H * hd), dtype, lead=lead),
        "wk": dense_init(gen, (D, KV * hd), dtype, lead=lead),
        "wv": dense_init(gen, (D, KV * hd), dtype, lead=lead),
        "wo": dense_init(gen, (H * hd, D), dtype, lead=lead),
    }
    zeros = lambda n: torch.zeros(tuple(lead) + (n,), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    ones = lambda n: torch.ones(tuple(lead) + (n,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H * hd), zeros(KV * hd), zeros(KV * hd)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ones(hd)}
        p["k_norm"] = {"scale": ones(hd)}
    return p


def _qkv(p, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.num_heads, hd)
    k = k.reshape(B, T, cfg.num_kv_heads, hd)
    v = v.reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v, mask, num_kv_heads: int):
    """q: (B,Tq,H,hd) k/v: (B,Tk,KV,hd); mask: (Tq,Tk) or (B,Tq,Tk) bool.
    Scores are divided by sqrt(hd) in float32; masked scores are NEG_INF."""
    B, Tq, H, hd = q.shape
    kv = num_kv_heads
    g = H // kv
    qf = q.reshape(B, Tq, kv, g, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / (hd ** 0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def sdpa_chunked(q, k, v, num_kv_heads: int, *, chunk: int, window=None,
                 bidirectional: bool = False):
    """Online-softmax attention over kv chunks — never materializes S x S.

    The reference's flash-style formulation (running max and sum over kv
    chunks), as a Python loop; differentiable.  Used when
    ``cfg.attn_impl == "chunked"``."""
    B, Tq, H, hd = q.shape
    S = k.shape[1]
    kv = num_kv_heads
    g = H // kv
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"pad S={S} to a multiple of chunk={chunk}")
    qf = q.reshape(B, Tq, kv, g, hd).float() * (hd ** -0.5)
    qpos = torch.arange(Tq, device=q.device)
    acc = torch.zeros((B, kv, g, Tq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, kv, g, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, kv, g, Tq), dtype=torch.float32, device=q.device)
    for j in range(S // chunk):
        k_c = k[:, j * chunk:(j + 1) * chunk].float()
        v_c = v[:, j * chunk:(j + 1) * chunk].float()
        scores = torch.einsum("btkgh,bskh->bkgts", qf, k_c)
        if not bidirectional:
            kpos = j * chunk + torch.arange(chunk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            scores = torch.where(mask, scores, torch.tensor(
                NEG_INF, dtype=scores.dtype, device=scores.device))
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bskh->bkgth", p, v_c)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)


def sdpa_banded(q, k, v, num_kv_heads: int, *, window: int):
    """Sliding-window attention in O(S 2W): each W-sized query block
    attends only to its own and the previous key block (a relative mask
    inside), the reference's memory-roofline form for sliding-window
    training (hymba).  S must be a multiple of ``window``."""
    B, S, H, hd = q.shape
    kv = num_kv_heads
    g = H // kv
    W = window
    if S % W:
        raise ValueError(f"pad S={S} to a multiple of window={W}")
    nb = S // W
    qf = q.reshape(B, nb, W, kv, g, hd).float() * (hd ** -0.5)
    kb = k.reshape(B, nb, W, kv, hd).float()
    vb = v.reshape(B, nb, W, kv, hd).float()
    # the previous block (zeros before block 0)
    zeros = torch.zeros_like(kb[:, :1])
    k2 = torch.cat([torch.cat([zeros, kb[:, :-1]], 1), kb], dim=2)
    v2 = torch.cat([torch.cat([zeros, vb[:, :-1]], 1), vb], dim=2)
    scores = torch.einsum("bntkgh,bnskh->bnkgts", qf, k2)  # (B,nb,kv,g,W,2W)
    qpos = torch.arange(W, device=q.device)[:, None]
    kpos = torch.arange(2 * W, device=q.device)[None, :] - W
    rel = qpos - kpos  # how far behind the key is
    mask = (rel >= 0) & (rel < W)  # causal + window
    first = torch.arange(2 * W, device=q.device)[None, :] >= W
    m_all = mask[None].expand(nb, W, 2 * W).clone()
    m_all[0] = mask & first  # block 0 has no previous block
    scores = torch.where(m_all[None, :, None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnkgts,bnskh->bntkgh", w, v2)
    return out.reshape(B, S, H, hd).to(q.dtype)


def causal_mask(T: int, window: Optional[int] = None, device=None):
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def gqa_train(p, cfg: ModelConfig, x, bidirectional: bool = False):
    """Full-sequence GQA over ``x`` (B, T, D) at positions 0..T-1."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    if (cfg.attn_impl == "chunked" and not bidirectional and cfg.window
            and T % cfg.window == 0 and T > cfg.window):
        out = sdpa_banded(q, k, v, cfg.num_kv_heads, window=cfg.window)
    elif cfg.attn_impl == "chunked":
        out = sdpa_chunked(q, k, v, cfg.num_kv_heads,
                           chunk=min(cfg.attn_chunk, T), window=cfg.window,
                           bidirectional=bidirectional)
    else:
        mask = (torch.ones((T, T), dtype=torch.bool, device=x.device)
                if bidirectional else causal_mask(T, cfg.window, x.device))
        out = sdpa(q, k, v, mask, cfg.num_kv_heads)
    return out.reshape(B, T, -1) @ p["wo"]


def gqa_encode(p, cfg: ModelConfig, x):
    """Bidirectional GQA over ``x`` (B, S, D) at positions 0..S-1, the
    serving path's encoder attention: ``gqa_train(bidirectional=True)``'s
    function through ``ops.flash_attention(causal=False)``, the
    hand-written kernel for CUDA tensors (the plain form would hold every
    (B, H, S, S) score in float32), the plain version for CPU tensors."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, torch.arange(S, device=x.device))
    out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------


def xattn_init(gen, cfg: ModelConfig, lead=()):
    dtype = param_dtype(cfg)
    hd = cfg.resolved_head_dim
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, (D, H * hd), dtype, lead=lead),
        "wk": dense_init(gen, (D, KV * hd), dtype, lead=lead),
        "wv": dense_init(gen, (D, KV * hd), dtype, lead=lead),
        "wo": dense_init(gen, (H * hd, D), dtype, lead=lead),
    }


def xattn_kv(p, cfg: ModelConfig, kv_feats):
    """The keys and values (B, S_enc, KV, hd) of the encoder output
    ``kv_feats`` (B, S_enc, D): no rope, as the cache holds them."""
    B, S, _ = kv_feats.shape
    shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((kv_feats @ p["wk"]).reshape(shape),
            (kv_feats @ p["wv"]).reshape(shape))


def xattn_attend(p, cfg: ModelConfig, x, k, v):
    """Queries of ``x`` (B, T, D) against every encoder key, all visible,
    in plain ``sdpa`` as the reference computes it (the flash kernel takes
    only equal query and key lengths)."""
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, cfg.num_heads, cfg.resolved_head_dim)
    mask = torch.ones((T, k.shape[1]), dtype=torch.bool, device=x.device)
    out = sdpa(q, k, v, mask, cfg.num_kv_heads)
    return out.reshape(B, T, -1) @ p["wo"]


def xattn(p, cfg: ModelConfig, x, kv_feats):
    """Cross-attention of ``x`` (B, T, D) over the encoder output
    ``kv_feats`` (B, S_enc, D)."""
    return xattn_attend(p, cfg, x, *xattn_kv(p, cfg, kv_feats))


# ---------------------------------------------------------------------------
# contiguous ring KV cache (the scan engine)
# ---------------------------------------------------------------------------


def gqa_cache_init(cfg: ModelConfig, batch: int, capacity: int,
                   num_layers: int, device="cuda"):
    """Ring KV cache ``(L, B, capacity, KV, hd)`` in the param dtype, and
    the absolute position held by each ring slot, ``pos_ids`` (L, capacity)
    int32, -1 where empty."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    dtype = param_dtype(cfg)
    shape = (num_layers, batch, capacity, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos_ids": torch.full((num_layers, capacity), -1, dtype=torch.int32,
                              device=device),
    }


def gqa_prefill(p, cfg: ModelConfig, x, cache_l):
    """Whole-prompt attention over ``x`` (B, T, D) at positions 0..T-1 that
    also fills this layer's ring (``cache_l``: per-layer views, written in
    place).  The ring keeps the last ``capacity`` tokens at slot
    ``pos % capacity``, so decode appends at ``pos % capacity``.

    The attention is ``ops.flash_attention`` (causal, ``cfg.window``) —
    the hand-written kernel for CUDA tensors, the plain masked softmax for
    CPU tensors — whatever ``cfg.attn_impl`` says: the reference's naive,
    chunked and banded forms all compute that function.
    Returns ``(out (B, T, D), cache_l)``."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    ck, cv, cpos = cache_l["k"], cache_l["v"], cache_l["pos_ids"]
    cap = ck.shape[1]
    if cap <= T:
        start = T - cap
        shift = start % cap
        ck.copy_(torch.roll(k[:, start:], shift, dims=1))
        cv.copy_(torch.roll(v[:, start:], shift, dims=1))
        cpos.copy_(torch.roll(torch.arange(start, T, dtype=torch.int32,
                                           device=x.device), shift))
    else:
        ck[:, :T] = k
        cv[:, :T] = v
        cpos[:T] = positions.to(torch.int32)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    return out.reshape(B, T, -1) @ p["wo"], cache_l


def gqa_decode(p, cfg: ModelConfig, x, cache_l, pos: int):
    """One-token decode of ``x`` (B, 1, D) at absolute position ``pos``
    against this layer's ring (views, written in place): the token's K/V
    go to slot ``pos % capacity``, then it attends to every filled slot
    (within the window, if any) with plain ``sdpa``, as the reference
    computes it outside any Pallas kernel.  Returns ``(out, cache_l)``."""
    B, T, _ = x.shape
    assert T == 1
    q, k, v = _qkv(p, cfg, x, torch.full((1,), pos, device=x.device))
    ck, cv, cpos = cache_l["k"], cache_l["v"], cache_l["pos_ids"]
    slot = pos % ck.shape[1]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    cpos[slot] = pos
    valid = cpos >= 0
    if cfg.window is not None:
        valid = valid & (cpos > pos - cfg.window)
    out = sdpa(q, ck, cv, valid[None, :], cfg.num_kv_heads)
    return out.reshape(B, 1, -1) @ p["wo"], cache_l


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, lead=()):
    dtype = param_dtype(cfg)
    H, D, r = cfg.num_heads, cfg.d_model, cfg.kv_lora_rank
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": dense_init(gen, (D, H * qd), dtype, lead=lead),
        "w_dkv": dense_init(gen, (D, r), dtype, lead=lead),
        "w_krope": dense_init(gen, (D, cfg.qk_rope_dim), dtype, lead=lead),
        "w_uk": dense_init(gen, (r, H * cfg.qk_nope_dim), dtype, lead=lead),
        "w_uv": dense_init(gen, (r, H * cfg.v_head_dim), dtype, lead=lead),
        "wo": dense_init(gen, (H * cfg.v_head_dim, D), dtype, lead=lead),
    }


def _mla_q(p, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, cfg.num_heads,
                              cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p, cfg: ModelConfig, x, positions):
    """The latent ``ckv`` (B, T, r) and the shared rope key ``krope``
    (B, T, rope), as the cache holds them."""
    ckv = x @ p["w_dkv"]
    krope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    return ckv, krope


def _mla_expand(p, cfg: ModelConfig, x):
    """Whole-sequence MLA's inputs over ``x`` (B, T, D) at positions
    0..T-1, the latents expanded to per-head keys and values: ``(q_nope,
    q_rope, k_nope, v, ckv, krope)``."""
    B, T, _ = x.shape
    H = cfg.num_heads
    positions = torch.arange(T, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv, krope = _mla_latents(p, cfg, x, positions)
    k_nope = (ckv @ p["w_uk"]).reshape(B, T, H, cfg.qk_nope_dim)
    v = (ckv @ p["w_uv"]).reshape(B, T, H, cfg.v_head_dim)
    return q_nope, q_rope, k_nope, v, ckv, krope


def _mla_prefill_attend(p, cfg: ModelConfig, x):
    """The prefill's whole-sequence MLA.  The attention is
    ``ops.flash_attention`` (causal): q = [q_nope, q_rope] and k = [k_nope,
    krope on every head], both ``qk_nope_dim + qk_rope_dim`` wide, v
    ``v_head_dim`` wide; its ``hd**-0.5`` on the q/k width is the
    reference's scale.  Returns ``(out (B, T, D), ckv, krope)``."""
    B, T, _ = x.shape
    q_nope, q_rope, k_nope, v, ckv, krope = _mla_expand(p, cfg, x)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, T, cfg.num_heads, cfg.qk_rope_dim)], dim=-1)
    out = ops.flash_attention(q, k, v.contiguous(), causal=True)
    return out.reshape(B, T, -1) @ p["wo"], ckv, krope


def mla_train(p, cfg: ModelConfig, x):
    """Training form of MLA over ``x`` (B, T, D), as the reference computes
    it: float32 scores ``q_nope k_nope + q_rope krope`` (the rope key shared
    by every head), a causal mask and a softmax, in plain PyTorch on both
    devices, so autograd differentiates it on the card."""
    B, T, _ = x.shape
    q_nope, q_rope, k_nope, v, _, krope = _mla_expand(p, cfg, x)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope.float())
              + torch.einsum("bthd,bsd->bhts", q_rope.float(), krope.float())
              ) * scale
    scores = torch.where(causal_mask(T, device=x.device)[None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", w, v.float()).to(x.dtype)
    return out.reshape(B, T, -1) @ p["wo"]


def mla_cache_init(cfg: ModelConfig, batch: int, capacity: int,
                   num_layers: int, device="cuda"):
    """The latent cache: ``ckv`` (L, B, capacity, kv_lora_rank) and
    ``krope`` (L, B, capacity, qk_rope_dim) in the param dtype, and
    ``pos_ids`` (L, capacity) int32, -1 where empty."""
    device = resolve_device(device)
    dtype = param_dtype(cfg)
    return {
        "ckv": torch.zeros((num_layers, batch, capacity, cfg.kv_lora_rank),
                           dtype=dtype, device=device),
        "krope": torch.zeros((num_layers, batch, capacity, cfg.qk_rope_dim),
                             dtype=dtype, device=device),
        "pos_ids": torch.full((num_layers, capacity), -1, dtype=torch.int32,
                              device=device),
    }


def mla_prefill(p, cfg: ModelConfig, x, cache_l):
    """Whole-prompt MLA through the flash route that also writes the
    prompt's latents into this layer's cache (views, written in place)
    from slot 0.  Returns ``(out, cache_l)``."""
    T = x.shape[1]
    out, ckv, krope = _mla_prefill_attend(p, cfg, x)
    cache_l["ckv"][:, :T] = ckv
    cache_l["krope"][:, :T] = krope
    cache_l["pos_ids"][:T] = torch.arange(T, dtype=torch.int32,
                                          device=x.device)
    return out, cache_l


def mla_decode(p, cfg: ModelConfig, x, cache_l, pos: int):
    """Absorbed one-token decode of ``x`` (B, 1, D) at position ``pos``:
    q_nope is taken through ``w_uk`` into latent space, scored against the
    latent cache, and the attention read out of it through ``w_uv``, in
    float32, as the reference computes it outside any Pallas kernel.  The
    token's latents go to slot ``pos % capacity`` first.  Returns
    ``(out, cache_l)``."""
    B, T, _ = x.shape
    assert T == 1
    H, r = cfg.num_heads, cfg.kv_lora_rank
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv_t, krope_t = _mla_latents(p, cfg, x, positions)
    ckv, krope, cpos = cache_l["ckv"], cache_l["krope"], cache_l["pos_ids"]
    slot = pos % ckv.shape[1]
    ckv[:, slot] = ckv_t[:, 0]
    krope[:, slot] = krope_t[:, 0]
    cpos[slot] = pos
    wk = p["w_uk"].reshape(r, H, cfg.qk_nope_dim).float()
    q_abs = torch.einsum("bthd,rhd->bthr", q_nope.float(), wk)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    ckv_f = ckv.float()
    scores = (torch.einsum("bthr,bsr->bhts", q_abs, ckv_f)
              + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                             krope.float())) * scale
    scores = torch.where((cpos >= 0)[None, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhts,bsr->bthr", w, ckv_f)
    wv = p["w_uv"].reshape(r, H, cfg.v_head_dim).float()
    out = torch.einsum("bthr,rhd->bthd", lat, wv).to(x.dtype)
    return out.reshape(B, 1, -1) @ p["wo"], cache_l


# ---------------------------------------------------------------------------
# paged KV cache (continuous-batching serving)
# ---------------------------------------------------------------------------

#: supported storage dtypes for the paged pools: None = the model's param
#: dtype (the bitwise-exact path); "int8" = per-page symmetric quantization
#: with a float32 scale per (layer, page)
KV_DTYPES = (None, "int8")

#: adaptive page scales start here and only ever grow (monotone)
KV_SCALE_FLOOR = 1e-8

#: page 0 (the runtime's scratch page) keeps this scale forever: masked
#: garbage writes from inactive slots must never adapt quantization state
KV_SCRATCH_SCALE = 1.0

Pool = object  # a tensor, or {"q": int8 tensor, "scale": f32 tensor}


def paged_pools_init(cfg: ModelConfig, num_pages: int, page_size: int,
                     num_layers: int, kv_dtype: Optional[str] = None,
                     device="cuda") -> Dict[str, Pool]:
    """Block-pool KV cache ``(num_layers, num_pages, page_size, KV, hd)``.

    ``kv_dtype=None`` stores pages in the model's param dtype.
    ``kv_dtype="int8"`` stores each pool as
    ``{"q": int8 (L, P, page_size, KV, hd), "scale": f32 (L, P)}`` with page
    0's scale pinned to :data:`KV_SCRATCH_SCALE`.  Page 0 is the runtime's
    scratch page for inactive slots.  The pools land on ``device`` (the
    card unless the caller asks for the CPU)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}; expected one of {KV_DTYPES}")
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (num_layers, num_pages, page_size, cfg.num_kv_heads, hd)
    if kv_dtype is None:
        dtype = param_dtype(cfg)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def pool():
        scale = torch.full((num_layers, num_pages), KV_SCALE_FLOOR,
                           dtype=torch.float32, device=device)
        scale[:, 0] = KV_SCRATCH_SCALE
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": scale}

    return {"k": pool(), "v": pool()}


def kv_quantize(x, scale):
    """Symmetric int8 quantization of ``x`` under per-page ``scale``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def kv_dequantize(q, scale):
    return q.float() * scale


def kv_page_scale(x, floor: Optional[float] = None):
    """The smallest symmetric-int8 scale covering ``x`` (amax / 127)."""
    floor = KV_SCALE_FLOOR if floor is None else floor
    return torch.clamp(torch.max(torch.abs(x)) / 127.0, min=floor)


def _round_clip_int8(x):
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def paged_store_rows(pool, page_idx, offset, rows):
    """Write one (KV, hd) row per batch entry at ``(page_idx[b], offset[b])``
    — the decode-step scatter — in place.

    int8 pools: the written pages' scales grow to cover the new rows
    (``max(old, amax(row)/127)``, merged over duplicate pages by a
    scatter-max), the touched pages' existing bits are rescaled by
    ``old/new`` (exactly 1.0 where the scale did not change), and page 0
    keeps :data:`KV_SCRATCH_SCALE`.  Duplicate pages gather the same old
    bits and rescale them identically, so any winner of the duplicate
    write is correct."""
    page_idx = page_idx.long()
    offset = offset.long()
    if not isinstance(pool, dict):
        pool[page_idx, offset] = rows.to(pool.dtype)
        return pool
    q, scale = pool["q"], pool["scale"]
    rows = rows.float()                                    # (B, KV, hd)
    row_amax = torch.amax(torch.abs(rows), dim=(1, 2))     # (B,)
    s_new = scale.clone().scatter_reduce_(0, page_idx, row_amax / 127.0,
                                          "amax", include_self=True)
    s_new[0] = KV_SCRATCH_SCALE
    ratio = (scale / s_new)[page_idx]                      # (B,)
    pages = _round_clip_int8(q[page_idx].float() * ratio[:, None, None, None])
    qrows = _round_clip_int8(rows / s_new[page_idx][:, None, None])
    q[page_idx] = pages
    q[page_idx, offset] = qrows
    scale.copy_(s_new)
    return pool


def paged_store_chunk(pool, page_table, positions, rows):
    """Write a contiguous chunk of rows for ONE slot — the prefill scatter —
    in place.  ``positions`` are absolute; their pages are
    ``page_table[pos // page_size]``.

    int8 pools follow :func:`paged_store_rows`' discipline over a page
    window of ``T // page_size + 2`` logical pages starting at the chunk's
    first page; window entries past the chunk's last page are redirected
    to the scratch page 0 (whose bits they rewrite unchanged)."""
    pos = positions.long()
    table = page_table.long()
    if not isinstance(pool, dict):
        page_size = pool.shape[1]
        pool[table[pos // page_size], pos % page_size] = rows.to(pool.dtype)
        return pool
    q, scale = pool["q"], pool["scale"]
    page_size = q.shape[1]
    max_pages = table.shape[0]
    rows = rows.float()                                    # (T, KV, hd)
    T = rows.shape[0]
    n_w = T // page_size + 2                               # page-window bound
    first = pos[0] // page_size
    window = first + torch.arange(n_w, device=pos.device)  # logical pages
    touched = window <= pos[T - 1] // page_size
    pids = torch.where(touched,
                       table[torch.clamp(window, max=max_pages - 1)],
                       torch.zeros_like(window))
    local = pos // page_size - first                       # (T,) in-window
    offs = pos % page_size
    row_amax = torch.amax(torch.abs(rows), dim=(1, 2))     # (T,)
    page_amax = torch.zeros((n_w,), dtype=torch.float32,
                            device=rows.device).scatter_reduce_(
        0, local, row_amax, "amax", include_self=True)
    s_old = scale[pids]
    s_new = torch.maximum(s_old, page_amax / 127.0)
    s_new = torch.where(pids == 0, torch.full_like(s_new, KV_SCRATCH_SCALE),
                        s_new)
    pages = q[pids].float()                                # (n_w, ps, KV, hd)
    pages = torch.round(pages * (s_old / s_new)[:, None, None, None])
    pages[local, offs] = torch.round(rows / s_new[local][:, None, None])
    q[pids] = torch.clamp(pages, -127, 127).to(torch.int8)
    scale[pids] = s_new
    return pool


def gqa_decode_paged(p, cfg: ModelConfig, x, k_pool_l, v_pool_l, page_table,
                     positions):
    """One-token decode for a batch of slots against the paged pool.

      x          : (B, 1, D) — one new token per slot
      k/v_pool_l : (P, page_size, KV, hd) — this layer's page pool (a view
                   into the stacked pool; written in place)
      page_table : (B, max_pages) int32
      positions  : (B,) int32 — absolute write position of each new token

    The attend goes through ``kernels.ops.paged_attention``: the Hopper
    kernel for CUDA tensors, the plain version for CPU tensors.
    Returns ``(out (B,1,D), k_pool_l, v_pool_l)``."""
    B, T, _ = x.shape
    assert T == 1
    q, k, v = _qkv(p, cfg, x, positions[:, None])
    quantized = isinstance(k_pool_l, dict)
    page_size = (k_pool_l["q"] if quantized else k_pool_l).shape[1]
    pos = positions.long()
    page_idx = page_table.long()[torch.arange(B, device=pos.device),
                                 pos // page_size]          # (B,)
    offset = pos % page_size
    paged_store_rows(k_pool_l, page_idx, offset, k[:, 0])
    paged_store_rows(v_pool_l, page_idx, offset, v[:, 0])
    lengths = (pos + 1).to(torch.int32)  # context incl. this token
    table = page_table.to(torch.int32)
    qd = q[:, 0].contiguous()
    if quantized:
        out = ops.paged_attention(qd, k_pool_l["q"], v_pool_l["q"], table,
                                  lengths, k_scale=k_pool_l["scale"],
                                  v_scale=v_pool_l["scale"])
    else:
        out = ops.paged_attention(qd, k_pool_l, v_pool_l, table, lengths)
    return out.reshape(B, 1, -1) @ p["wo"], k_pool_l, v_pool_l


def gqa_prefill_paged(p, cfg: ModelConfig, x, k_pool_l, v_pool_l, page_table,
                      positions):
    """Chunk/suffix prefill for ONE slot against the paged pool.

      x          : (1, T, D) — hidden states of a contiguous prompt chunk
      page_table : (max_pages,) int32 — the slot's pages, prompt order
      positions  : (T,) int32 — absolute positions pos0 .. pos0+T-1

    Writes the chunk's K/V into the slot's pages, then attends over the
    table-gathered context under the causal mask ``j <= position``."""
    B, T, _ = x.shape
    assert B == 1
    q, k, v = _qkv(p, cfg, x, positions)
    pos = positions.long()
    table = page_table.long()
    paged_store_chunk(k_pool_l, page_table, pos, k[0])
    paged_store_chunk(v_pool_l, page_table, pos, v[0])
    KV, hd = cfg.num_kv_heads, k.shape[-1]
    if isinstance(k_pool_l, dict):
        kc = kv_dequantize(k_pool_l["q"][table],
                           k_pool_l["scale"][table][:, None, None, None])
        vc = kv_dequantize(v_pool_l["q"][table],
                           v_pool_l["scale"][table][:, None, None, None])
        kc = kc.reshape(1, -1, KV, hd)
        vc = vc.reshape(1, -1, KV, hd)
    else:
        kc = k_pool_l[table].reshape(1, -1, KV, hd)
        vc = v_pool_l[table].reshape(1, -1, KV, hd)
    ctx = kc.shape[1]
    mask = (torch.arange(ctx, device=pos.device)[None, :]
            <= pos[:, None])  # (T, ctx)
    out = sdpa(q, kc, vc, mask, cfg.num_kv_heads)
    return out.reshape(B, T, -1) @ p["wo"], k_pool_l, v_pool_l
