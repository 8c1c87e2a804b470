"""State-space sequence mixers: the selective SSM (Mamba, for the hybrid
family) and RWKV-6 "Finch" (data-dependent decay linear attention).

Port of ``repro/models/ssm.py``.  Each mixer's full-sequence form serves
training and prefill, and its O(1)-state form serves decode, carrying a
state per layer.

**Mamba** (``dt_rank``, ``mamba_init``, ``mamba_state_init``, the causal
depthwise conv, ``_mamba_core``, ``mamba_train`` / ``mamba_prefill`` /
``mamba_decode``): the projections, the k-tap depthwise conv and the
gates are plain PyTorch, as the reference computes them outside any
Pallas kernel; the recurrence, the reference's ``lax.scan`` over time,
goes through ``kernels.ops.selective_scan``: the hand-written CUDA kernel
for CUDA tensors (one launch a call, prefill and decode alike), the plain
step loop for CPU tensors, and in training its backward (the CUDA
backward kernel on the card, the plain reverse recurrence on the CPU).
The dtypes follow the reference step by step, so the kernel path and the
plain path differ only by the scan's summation order.

**RWKV-6** (``rwkv_heads``, ``rwkv6_init``, ``rwkv_state_init``, the
token shift, the time and channel mixes and ``rwkv6_block``): the WKV
recurrence of the time mix goes through ``kernels.ops.rwkv6_scan``: the
hand-written CUDA kernel for CUDA tensors, the plain step loop for CPU
tensors.  Where the reference runs the recurrence as a ``lax.scan`` from
a carried state ``S0``, the kernel takes ``S0`` and returns the final
state.  In training, where the reference differentiates that scan,
``ops.rwkv6_scan``'s backward gives the grads of r, k, v, w, u, and of
``S0`` where one is given (training starts from ``S0`` None, a zero
state); the CUDA backward kernel on the card, the plain reverse
recurrence on the CPU.  The rest of the time mix is plain autograd, so
the grads reach ``w0`` and ``w_lora_*`` through ``w = exp(-exp(w_dd))``
and the bonus ``u`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, param_dtype, rmsnorm,
                                       rmsnorm_init)

LORA_RANK = 32  # rank of the decay's low-rank projection, as the reference


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (arXiv:2312.00752, simplified; used by Hymba)
# ---------------------------------------------------------------------------


def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """The reference's ``mamba_init`` tree, with ``lead`` stacked axes
    (layers) in front of every leaf; ``A_log`` and ``D`` stay float32."""
    dtype = param_dtype(cfg)
    D, DI, S = cfg.d_model, cfg.d_inner, cfg.ssm_state
    R = dt_rank(cfg)
    lead = tuple(lead)
    dev = gen.device

    def dense(shape, scale=None):
        return dense_init(gen, shape, dtype, scale=scale, lead=lead)

    a_log = torch.log(torch.arange(1, S + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": dense((D, 2 * DI)),
        "conv_w": dense((cfg.ssm_conv, DI), scale=0.5),
        "conv_b": torch.zeros(lead + (DI,), dtype=dtype, device=dev),
        "x_proj": dense((DI, R + 2 * S)),
        "dt_proj": dense((R, DI)),
        "dt_bias": torch.full(lead + (DI,), -2.0, dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (DI, S)).clone(),
        "D": torch.ones(lead + (DI,), dtype=torch.float32, device=dev),
        "out_proj": dense((DI, D)),
    }


def mamba_shapes(cfg: ModelConfig, num_layers: int):
    """The stacked mamba tree as ``meta`` tensors (shapes and dtypes)."""
    dtype = param_dtype(cfg)
    D, DI, S, L = cfg.d_model, cfg.d_inner, cfg.ssm_state, num_layers
    R = dt_rank(cfg)

    def m(*shape, dt=dtype):
        return torch.empty((L,) + shape, dtype=dt, device="meta")

    return {"in_proj": m(D, 2 * DI), "conv_w": m(cfg.ssm_conv, DI),
            "conv_b": m(DI), "x_proj": m(DI, R + 2 * S), "dt_proj": m(R, DI),
            "dt_bias": m(DI), "A_log": m(DI, S, dt=torch.float32),
            "D": m(DI, dt=torch.float32), "out_proj": m(DI, D)}


def mamba_state_init(cfg: ModelConfig, batch: int, num_layers: int,
                     device: DeviceLike = "cuda"):
    """Zero decode state of every layer: the SSM state ``h`` (L,B,DI,S)
    float32 and the conv's left context ``conv`` (L,B,k-1,DI) in the param
    dtype."""
    dev = resolve_device(device)
    DI, S = cfg.d_inner, cfg.ssm_state
    return {
        "h": torch.zeros((num_layers, batch, DI, S), dtype=torch.float32,
                         device=dev),
        "conv": torch.zeros((num_layers, batch, cfg.ssm_conv - 1, DI),
                            dtype=param_dtype(cfg), device=dev),
    }


def _causal_depthwise_conv(p, cfg: ModelConfig, xz, prev):
    """xz: (B,T,DI); prev: (B, k-1, DI) left context.  Returns ``(out,
    new_prev)``, the k shifted products summed in the reference's order."""
    k = cfg.ssm_conv
    padded = torch.cat([prev.to(xz.dtype), xz], dim=1)  # (B, T+k-1, DI)
    T = xz.shape[1]
    out = torch.zeros_like(xz)
    for i in range(k):
        out = out + padded[:, i:i + T] * p["conv_w"][i]
    new_prev = padded[:, -(k - 1):] if k > 1 else prev
    return out + p["conv_b"], new_prev


def _mamba_core(p, cfg: ModelConfig, u, h0):
    """u: (B,T,DI) post-conv activations; h0: the initial state (B,DI,S),
    or None for a zero state whose final value is not wanted (training:
    the scan kernel then neither reads nor writes a state).  Returns
    ``(y + D u in u's dtype, the final state or None)``."""
    S = cfg.ssm_state
    R = dt_rank(cfg)
    proj = u @ p["x_proj"]  # (B,T,R+2S)
    dt_in, Bmat, Cmat = torch.split(proj, [R, S, S], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])  # (DI, S)
    out = ops.selective_scan(
        u.float().contiguous(), dt.contiguous(), Bmat.float().contiguous(),
        Cmat.float().contiguous(), A.float().contiguous(),
        state=None if h0 is None else h0.float().contiguous())
    y, h = (out, None) if h0 is None else out
    return (y + p["D"] * u.float()).to(u.dtype), h


def mamba_prefill(p, cfg: ModelConfig, x, state_l):
    """x: (B,T,D) -> ``(out, new_state)``.  ``state_l``: this layer's
    ``{"h", "conv"}``, or None for a zero start whose new state is not
    wanted (training); the new state is then None."""
    DI = cfg.d_inner
    xs, z = torch.split(x @ p["in_proj"], [DI, DI], dim=-1)
    prev = (xs.new_zeros((x.shape[0], cfg.ssm_conv - 1, DI))
            if state_l is None else state_l["conv"])
    u, conv_prev = _causal_depthwise_conv(p, cfg, xs, prev)
    y, h = _mamba_core(p, cfg, F.silu(u),
                       None if state_l is None else state_l["h"])
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, None if state_l is None else {"h": h, "conv": conv_prev}


def mamba_train(p, cfg: ModelConfig, x):
    """The full sequence from a zero state, as the reference's
    ``mamba_train``; the final state is neither computed nor kept."""
    return mamba_prefill(p, cfg, x, None)[0]


def mamba_decode(p, cfg: ModelConfig, x, state_l):
    """x: (B,1,D) single-token decode with O(1) state.  Returns ``(out,
    new_state)`` (new tensors; ``state_l`` is not written)."""
    DI = cfg.d_inner
    xs, z = torch.split(x @ p["in_proj"], [DI, DI], dim=-1)
    hist = torch.cat([state_l["conv"].to(xs.dtype), xs], dim=1)  # (B,k,DI)
    u = torch.einsum("bkd,kd->bd", hist, p["conv_w"]) + p["conv_b"]
    y, h = _mamba_core(p, cfg, F.silu(u)[:, None], state_l["h"])
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"h": h, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# RWKV-6 "Finch" (arXiv:2404.05892): data-dependent decay linear attention
# ---------------------------------------------------------------------------


def rwkv_heads(cfg: ModelConfig) -> int:
    if cfg.d_model % cfg.rwkv_head_dim:
        raise ValueError(f"d_model={cfg.d_model} is not a multiple of "
                         f"rwkv_head_dim={cfg.rwkv_head_dim}")
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """The reference's ``rwkv6_init`` tree, with ``lead`` stacked axes
    (layers) in front of every leaf; ``w0`` and ``u`` stay float32."""
    dtype = param_dtype(cfg)
    D, Fd = cfg.d_model, cfg.d_ff
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    def dense(shape, scale=None):
        return dense_init(gen, shape, dtype, scale=scale, lead=lead)

    return {
        "tm": {  # time mix
            "mu": full((5, D), 0.5, dtype),  # token-shift mix of r,k,v,w,g
            "w0": full((D,), 0.0, torch.float32),  # decay base
            "w_lora_a": dense((D, LORA_RANK)),
            "w_lora_b": dense((LORA_RANK, D), scale=0.01),
            "wr": dense((D, D)),
            "wk": dense((D, D)),
            "wv": dense((D, D)),
            "wg": dense((D, D)),
            "wo": dense((D, D)),
            "u": full((H, hd), 0.0, torch.float32),  # per-head bonus
            "ln": rmsnorm_init(D, dtype, lead=lead, device=dev),
        },
        "cm": {  # channel mix
            "mu": full((2, D), 0.5, dtype),  # k, r shifts
            "wk": dense((D, Fd)),
            "wv": dense((Fd, D)),
            "wr": dense((D, D)),
        },
    }


def rwkv6_shapes(cfg: ModelConfig, num_layers: int):
    """The stacked rwkv6 tree as ``meta`` tensors (shapes and dtypes)."""
    dtype = param_dtype(cfg)
    D, Fd, L = cfg.d_model, cfg.d_ff, num_layers
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim

    def m(*shape, dt=dtype):
        return torch.empty((L,) + shape, dtype=dt, device="meta")

    return {
        "tm": {"mu": m(5, D), "w0": m(D, dt=torch.float32),
               "w_lora_a": m(D, LORA_RANK), "w_lora_b": m(LORA_RANK, D),
               "wr": m(D, D), "wk": m(D, D), "wv": m(D, D), "wg": m(D, D),
               "wo": m(D, D), "u": m(H, hd, dt=torch.float32),
               "ln": {"scale": m(D)}},
        "cm": {"mu": m(2, D), "wk": m(D, Fd), "wv": m(Fd, D), "wr": m(D, D)},
    }


def rwkv_state_init(cfg: ModelConfig, batch: int, num_layers: int,
                    device: DeviceLike = "cuda"):
    """Zero decode state of every layer: the WKV state ``S``
    (L,B,H,hd,hd) float32 and the last token of each mix's input
    ``x_tm``, ``x_cm`` (L,B,D) in the param dtype."""
    dev = resolve_device(device)
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    D = cfg.d_model
    dtype = param_dtype(cfg)
    return {
        "S": torch.zeros((num_layers, batch, H, hd, hd), dtype=torch.float32,
                         device=dev),
        "x_tm": torch.zeros((num_layers, batch, D), dtype=dtype, device=dev),
        "x_cm": torch.zeros((num_layers, batch, D), dtype=dtype, device=dev),
    }


def _token_shift(x, prev):
    """x: (B,T,D), prev: (B,D) -> x shifted right by one with prev injected."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_time_mix(p, cfg: ModelConfig, x, S0, x_prev):
    """Returns ``(out (B,T,D), final WKV state, x[:, -1])``; ``S0`` None
    is a zero state whose final state is not wanted (training), and the
    final state returned is then None."""
    B, T, D = x.shape
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    xs = _token_shift(x, x_prev)
    mu = p["mu"]
    xr = x + (xs - x) * mu[0]
    xk = x + (xs - x) * mu[1]
    xv = x + (xs - x) * mu[2]
    xw = x + (xs - x) * mu[3]
    xg = x + (xs - x) * mu[4]

    r = (xr @ p["wr"]).reshape(B, T, H, hd).float()
    k = (xk @ p["wk"]).reshape(B, T, H, hd).float()
    v = (xv @ p["wv"]).reshape(B, T, H, hd).float()
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (the RWKV6 signature): w in (0,1) per channel/step
    w_dd = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_dd)).reshape(B, T, H, hd)
    out = ops.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                         w.contiguous(), p["u"].float().contiguous(),
                         state=None if S0 is None
                         else S0.float().contiguous())
    y, S = (out, None) if S0 is None else out
    y = y.reshape(B, T, D).to(x.dtype)
    y = rmsnorm(p["ln"], y, cfg.norm_eps) * g
    return y @ p["wo"], S, x[:, -1]


def _rwkv_channel_mix(p, x, x_prev):
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * p["mu"][0]
    xr = x + (xs - x) * p["mu"][1]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1]


def rwkv6_block(p, cfg: ModelConfig, x, state_l, norms):
    """Full RWKV block: time mix + channel mix, each after its pre-norm.

    ``norms``: the block's ``ln1``/``ln2`` rmsnorm params; ``state_l``:
    this layer's ``{"S", "x_tm", "x_cm"}`` (``S`` None: a zero WKV state
    whose final value is not wanted, as in training).  Returns
    ``(x_out, new_state_l)`` (new tensors; ``state_l`` is not written)."""
    h = rmsnorm(norms["ln1"], x, cfg.norm_eps)
    y, S, x_tm = _rwkv_time_mix(p["tm"], cfg, h, state_l["S"], state_l["x_tm"])
    x = x + y
    h = rmsnorm(norms["ln2"], x, cfg.norm_eps)
    y, x_cm = _rwkv_channel_mix(p["cm"], h, state_l["x_cm"])
    x = x + y
    return x, {"S": S, "x_tm": x_tm, "x_cm": x_cm}
