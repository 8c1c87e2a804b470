"""Deterministic synthetic data: the image task and the LM task.

Port of ``repro/data/synthetic.py``.  Both tasks are drawn from seeds with
enough learnable structure that optimization dynamics (loss decrease,
ensemble diversity, averaged-model behaviour) mean something:

  * image task -- a Gaussian mixture over smoothed class prototypes (the
    CIFAR stand-in of the paper's image-classification experiment);
  * LM task    -- an order-1 Markov chain over a small vocabulary with a
    random, Zipf-weighted transition table (each state prefers a few
    successors), so perplexity is learnable down to the chain's entropy.

Everything is drawn from integer seeds with ``torch.Generator``s
(``core.prng``): deterministic given the seed, but not the reference's
numbers.  Every member of a population draws its own stream (its own
seed).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.prng import fold_in, generator


# ---------------------------------------------------------------------------
# image classification task (CIFAR stand-in)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImageTask:
    prototypes: torch.Tensor  # (C, H, W, 3) float32
    num_classes: int
    noise: float


def smooth_prototypes(raw: torch.Tensor) -> torch.Tensor:
    """Low-pass raw prototypes (C, H, W, 3) so that nearby pixels
    correlate: a 3x3 box filter on each colour channel, ``"SAME"`` with
    zero padding."""
    c, h, w, ch = raw.shape
    planes = raw.permute(0, 3, 1, 2).reshape(c * ch, 1, h, w)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=raw.dtype,
                     device=raw.device)
    smooth = F.conv2d(planes, box, padding=1)
    return smooth.reshape(c, ch, h, w).permute(0, 2, 3, 1).contiguous()


def make_image_task(seed: int, num_classes: int = 10, hw: int = 16,
                    noise: float = 0.35, device="cuda") -> ImageTask:
    """Prototypes N(0, 0.8^2) per pixel, smoothed, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    raw = torch.randn((num_classes, hw, hw, 3), generator=generator(seed, dev),
                      device=dev) * 0.8
    return ImageTask(smooth_prototypes(raw), num_classes, noise)


def sample_images(task: ImageTask, seed: int, batch: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (batch, H, W, 3) float32, labels (batch,) int64): uniform
    labels, each image its class's prototype plus N(0, noise^2) pixels."""
    protos = task.prototypes
    dev = protos.device
    labels = torch.randint(0, task.num_classes, (batch,),
                           generator=generator(fold_in(seed, 0), dev),
                           device=dev)
    noise = torch.randn((batch,) + tuple(protos.shape[1:]),
                        generator=generator(fold_in(seed, 1), dev), device=dev)
    return protos[labels] + task.noise * noise, labels


def eval_images(task: ImageTask, seed: int, batch: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed held-out batch (same seed -> same eval set)."""
    return sample_images(task, seed, batch)


# ---------------------------------------------------------------------------
# LM task (Markov chain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMTask:
    table: torch.Tensor  # (V, V) float32 transition logits
    vocab: int


def _gumbel(shape, seed: int, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator(seed, device), device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_lm_task(seed: int, vocab: int = 256, branching: float = 4.0,
                 device="cuda") -> LMTask:
    """Gumbel(0, 1) transition logits scaled by ``branching``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return LMTask(_gumbel((vocab, vocab), seed, resolve_device(device))
                  * branching, vocab)


def sample_tokens(task: LMTask, seed: int, batch: int, seq: int
                  ) -> torch.Tensor:
    """(batch, seq) int64 token ids: a uniform first token, then each next
    token drawn from the chain's row of the previous one (Gumbel-max)."""
    device = task.table.device
    x = torch.randint(0, task.vocab, (batch,), generator=generator(
        fold_in(seed, 0), device), device=device)
    noise = _gumbel((max(seq - 1, 0), batch, task.vocab), fold_in(seed, 1),
                    device)
    out = [x]
    for t in range(seq - 1):
        x = torch.argmax(task.table[x] + noise[t], dim=-1)
        out.append(x)
    return torch.stack(out, dim=1)
