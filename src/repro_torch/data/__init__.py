"""Synthetic data pipelines + per-member augmentation policies."""

from repro_torch.data.synthetic import (
    ImageTask,
    LMTask,
    eval_images,
    make_image_task,
    make_lm_task,
    sample_images,
    sample_tokens,
)
from repro_torch.data.augment import (
    AugmentPolicy,
    apply_policy,
    draw_policy,
    member_policies,
    soft_cross_entropy,
)

__all__ = [
    "ImageTask",
    "LMTask",
    "make_image_task",
    "make_lm_task",
    "sample_images",
    "eval_images",
    "sample_tokens",
    "AugmentPolicy",
    "draw_policy",
    "member_policies",
    "apply_policy",
    "soft_cross_entropy",
]
