"""Per-member data augmentations and regularizations (paper Appendix).

Port of ``repro/data/augment.py``.  In the heterogeneous setting each
member draws a (mixup, label smoothing, cutmix, random erasing) policy
from the paper's CIFAR menus.  Every augmentation yields *soft labels*,
so the classifier loss is a soft cross-entropy throughout.

Applying a policy is two steps: :func:`draw_augment` draws the random
numbers a batch needs (an :class:`AugmentDraw`) and :func:`apply_draw`
applies them, so a test can hand the reference's draws across as data.
Seeds play the role of the reference's keys (``core.prng``).  Scalars
(the menu picks, the Beta-distributed mixing weights, the cutmix box
centre) come from a seeded ``numpy.random.Generator`` on the host; the
per-image draws (the partner permutation, the erased squares' corners)
from ``torch.Generator``s on the images' device.  No global generator is
touched.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.prng import fold_in, generator

MIXUP_MENU = (0.0, 0.5, 1.0)
SMOOTH_MENU = (0.0, 0.05, 0.1)
CUTMIX_MENU = (0.0, 0.5, 1.0)
ERASE_MENU = (0.0, 0.15, 0.35)


@dataclasses.dataclass(frozen=True)
class AugmentPolicy:
    mixup: float = 0.0
    smooth: float = 0.0
    cutmix: float = 0.0
    erase: float = 0.0


def _host_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _pick(seed: int, menu: Sequence[float]) -> float:
    return menu[int(_host_rng(seed).integers(len(menu)))]


def draw_policy(seed: int) -> AugmentPolicy:
    """One entry of each menu, uniformly."""
    return AugmentPolicy(mixup=_pick(fold_in(seed, 0), MIXUP_MENU),
                         smooth=_pick(fold_in(seed, 1), SMOOTH_MENU),
                         cutmix=_pick(fold_in(seed, 2), CUTMIX_MENU),
                         erase=_pick(fold_in(seed, 3), ERASE_MENU))


def member_policies(seed: int, n: int, heterogeneous: bool
                    ) -> List[AugmentPolicy]:
    """Member i's policy from ``fold_in(seed, i)``; all-off when the
    population is homogeneous."""
    if not heterogeneous:
        return [AugmentPolicy() for _ in range(n)]
    return [draw_policy(fold_in(seed, i)) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class AugmentDraw:
    """The random numbers one batch's augmentation uses; a field the
    policy does not use is None.  ``mix_lam`` and ``cut_lam`` hold
    float32 values."""

    perm: Optional[torch.Tensor] = None     # (B,) int64: each image's partner
    mix_lam: Optional[float] = None         # mixup weight, Beta(a, a)
    cut_lam: Optional[float] = None         # cutmix weight, Beta(a, a)
    cut_cy: Optional[int] = None            # cutmix box centre row
    cut_cx: Optional[int] = None            # cutmix box centre column
    erase_y: Optional[torch.Tensor] = None  # (B,) int64: erased square's top
    erase_x: Optional[torch.Tensor] = None  # (B,) int64: erased square's left


def erase_side(policy: AugmentPolicy, h: int) -> int:
    """Side of the erased square of images ``h`` pixels high."""
    return max(int(policy.erase * h), 1)


def draw_augment(seed: int, policy: AugmentPolicy, batch: int, h: int,
                 w: int, device) -> AugmentDraw:
    """The draws :func:`apply_draw` needs for ``batch`` images of ``h`` x
    ``w`` pixels under ``policy``, per-image ones on ``device``."""
    kw = {}
    if policy.mixup > 0.0 or policy.cutmix > 0.0:
        kw["perm"] = torch.randperm(batch, generator=generator(
            fold_in(seed, 0), device), device=device)
    if policy.mixup > 0.0:
        rng = _host_rng(fold_in(seed, 1))
        kw["mix_lam"] = float(np.float32(rng.beta(policy.mixup, policy.mixup)))
    if policy.cutmix > 0.0:
        rng = _host_rng(fold_in(seed, 2))
        kw["cut_lam"] = float(np.float32(rng.beta(policy.cutmix,
                                                  policy.cutmix)))
        kw["cut_cy"] = int(rng.integers(0, h))
        kw["cut_cx"] = int(rng.integers(0, w))
    if policy.erase > 0.0:
        side = erase_side(policy, h)  # square, from the height
        kw["erase_y"], kw["erase_x"] = (
            torch.randint(0, size - side + 1, (batch,), generator=generator(
                fold_in(seed, j), device), device=device)
            for j, size in ((3, h), (4, w)))
    return AugmentDraw(**kw)


def _one_hot(labels: torch.Tensor, num_classes: int, smooth: float
             ) -> torch.Tensor:
    oh = F.one_hot(labels.long(), num_classes).float()
    return oh * (1.0 - smooth) + smooth / num_classes


def _mix(lam: float, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``lam * a + (1 - lam) * b``, each weight a float32 value."""
    lam32 = np.float32(lam)
    return float(lam32) * a + float(np.float32(1.0) - lam32) * b


def apply_draw(images: torch.Tensor, labels: torch.Tensor, num_classes: int,
               policy: AugmentPolicy, draw: AugmentDraw
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, C), labels (B,) -> (images, soft labels (B,
    num_classes)), in the reference's order: smoothing, mixup, cutmix
    (with the same partners), erasing."""
    _, h, w, _ = images.shape
    y = _one_hot(labels, num_classes, policy.smooth)

    if policy.mixup > 0.0:
        images = _mix(draw.mix_lam, images, images[draw.perm])
        y = _mix(draw.mix_lam, y, y[draw.perm])

    if policy.cutmix > 0.0:
        # the box is [c - side // 2, c + side // 2) on each axis, side the
        # float32 sqrt(1 - lam) * size truncated, as the reference
        cut = np.sqrt(np.float32(1.0) - np.float32(draw.cut_lam))
        ch, cw = int(cut * np.float32(h)), int(cut * np.float32(w))
        r0, r1 = max(draw.cut_cy - ch // 2, 0), min(draw.cut_cy + ch // 2, h)
        c0, c1 = max(draw.cut_cx - cw // 2, 0), min(draw.cut_cx + cw // 2, w)
        if r1 > r0 and c1 > c0:
            partner = images[draw.perm]
            images = images.clone()
            images[:, r0:r1, c0:c1] = partner[:, r0:r1, c0:c1]
        area = np.clip(np.float32(ch * cw) / np.float32(h * w),
                       np.float32(0.0), np.float32(1.0))
        y = float(np.float32(1.0) - area) * y + float(area) * y[draw.perm]

    if policy.erase > 0.0:
        side = erase_side(policy, h)
        rows = torch.arange(h, device=images.device)[None, :, None, None]
        cols = torch.arange(w, device=images.device)[None, None, :, None]
        top = draw.erase_y[:, None, None, None]
        left = draw.erase_x[:, None, None, None]
        inside = ((rows >= top) & (rows < top + side)
                  & (cols >= left) & (cols < left + side))
        images = torch.where(inside, torch.zeros((), dtype=images.dtype,
                                                 device=images.device), images)

    return images, y


def apply_policy(seed: int, images: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, policy: AugmentPolicy
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment a batch under ``policy`` with draws from ``seed``: returns
    (images, soft labels)."""
    b, h, w, _ = images.shape
    draw = draw_augment(seed, policy, b, h, w, images.device)
    return apply_draw(images, labels, num_classes, policy, draw)


def soft_cross_entropy(logits: torch.Tensor, soft_labels: torch.Tensor
                       ) -> torch.Tensor:
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(soft_labels * lp, dim=-1))
