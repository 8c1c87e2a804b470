"""Concrete input batches for smoke tests and the train CLI.

Port of ``repro/launch/specs.py::concrete_batch`` for attention-only
language models (the families the port has): the batch is
``{"tokens": (B, S)}``.  Audio frames and vision patches wait for those
frontends.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.prng import generator


def concrete_batch(cfg: ModelConfig, seed: int, batch: int, seq: int,
                   device="cuda"):
    """Uniform random token ids in [0, vocab) from ``seed``, on ``device``
    (the card unless the caller asks for the CPU)."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend={cfg.frontend!r} inputs are not ported yet")
    device = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=generator(seed, device), device=device)
    return {"tokens": tokens}
