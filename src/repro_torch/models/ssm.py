"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent decay linear attention.

Port of the RWKV-6 half of ``repro/models/ssm.py`` (``rwkv_heads``,
``rwkv6_init``, ``rwkv_state_init``, the token shift, the time and channel
mixes and ``rwkv6_block``).  The full-sequence form serves prefill and the
same code with T = 1 serves decode, carrying an O(1) state per layer.

The WKV recurrence of the time mix goes through
``kernels.ops.rwkv6_scan``: the hand-written CUDA kernel for CUDA tensors,
the plain step loop for CPU tensors.  Where the reference runs the
recurrence as a ``lax.scan`` from a carried state ``S0``, the kernel takes
``S0`` and returns the final state.  The selective SSM (Mamba, for the
hybrid family) is not ported yet.
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
    """Returns ``(out (B,T,D), final WKV state, x[:, -1])``."""
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
    y, S = ops.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                          w.contiguous(), p["u"].float().contiguous(),
                          state=S0.float().contiguous())
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
    this layer's ``{"S", "x_tm", "x_cm"}``.  Returns
    ``(x_out, new_state_l)`` (new tensors; ``state_l`` is not written)."""
    h = rmsnorm(norms["ln1"], x, cfg.norm_eps)
    y, S, x_tm = _rwkv_time_mix(p["tm"], cfg, h, state_l["S"], state_l["x_tm"])
    x = x + y
    h = rmsnorm(norms["ln2"], x, cfg.norm_eps)
    y, x_cm = _rwkv_channel_mix(p["cm"], h, state_l["x_cm"])
    x = x + y
    return x, {"S": S, "x_tm": x_tm, "x_cm": x_cm}
