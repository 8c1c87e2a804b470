"""Concrete input batches for smoke tests and the train CLI.

Port of ``repro/launch/specs.py::concrete_batch``: ``{"tokens": (B, S)}``,
plus the stubbed modality inputs the reference feeds its frontends: audio
frame embeddings ``"frames"`` (B, num_frames, d_model) and vision patch
embeddings ``"patches"`` (B, num_patches, d_model), standard normal in the
config's dtype.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.prng import fold_in, generator
from repro_torch.models.layers import param_dtype


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
