"""Input specifications and concrete batches for every (architecture x
input shape).

Port of ``repro/launch/specs.py``.  ``input_specs`` returns tensors on
``torch.device("meta")``, the port's counterpart of
``jax.ShapeDtypeStruct`` (shapes and dtypes, nothing allocated), for the
dry run; ``concrete_batch`` draws small real batches for smoke tests and
the train CLI: ``{"tokens": (B, S)}``, plus the stubbed modality inputs
the reference feeds its frontends: audio frame embeddings ``"frames"``
(B, num_frames, d_model) and vision patch embeddings ``"patches"`` (B,
num_patches, d_model), standard normal in the config's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.prng import fold_in, generator
from repro_torch.models import transformer as M
from repro_torch.models.layers import param_dtype

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extra_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    dt = param_dtype(cfg)
    out: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        out["frames"] = _meta((batch, cfg.num_frames, cfg.d_model), dt)
    if cfg.frontend == "vision":
        out["patches"] = _meta((batch, cfg.num_patches, cfg.d_model), dt)
    return out


def train_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, s), torch.int32), **_extra_specs(cfg, b)}


def prefill_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    return train_specs(cfg, shape)


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """serve_step inputs: one new token + a cache of ``seq_len`` context
    (``models/transformer.py::init_cache`` on meta)."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": M.init_cache(cfg, b, s, device=META),
            "pos": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


def concrete_batch(cfg: ModelConfig, seed: int, batch: int, seq: int,
                   device="cuda"):
    """Uniform random token ids in [0, vocab) from ``seed``, and the
    frontend's frames or patches from ``fold_in(seed, 1)``, drawn on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=generator(seed, device), device=device)
    out = {"tokens": tokens}
    rows = {"audio": ("frames", cfg.num_frames),
            "vision": ("patches", cfg.num_patches)}.get(cfg.frontend)
    if rows is not None:
        name, n = rows
        out[name] = torch.randn(
            (batch, n, cfg.d_model), generator=generator(fold_in(seed, 1),
                                                         device),
            device=device).to(param_dtype(cfg))
    return out
