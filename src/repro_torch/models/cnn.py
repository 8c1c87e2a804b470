"""Image classifiers of the paper's image-classification experiment.

Port of ``repro/models/cnn.py``: the ResNet-lite (one residual block a
stage), VGG-lite and MLP members, GroupNorm for normalization (no running
statistics to shuffle or recompute).  Parameters are the reference's tree,
with its keys and leaf order (``embed`` / ``blocks[i]`` / ``head``,
``proj`` only where a stage changes width), so layer depths, WASH plans,
soups and ``.npz`` checkpoints are the same in both packages.

Layouts are the reference's: conv kernels HWIO, images NHWC.  Only
:func:`conv` and :func:`groupnorm` look at them as OIHW / NCHW, through
``permute`` views (a contiguous NHWC tensor viewed as NCHW is
channels-last, which cuDNN takes without a copy).  ``"SAME"`` padding is
XLA's: ``total = max((ceil(H/s) - 1) s + k - H, 0)``, ``total // 2`` low
and the rest high, so a 3x3 conv at stride 2 on an even size pads (0, 1),
which no ``padding=`` argument of ``F.conv2d`` gives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.prng import fold_in, generator

Tree = Any


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    kind: str = "resnet"  # resnet | vgg | mlp
    width: int = 32
    depth: int = 3  # stages (resnet/vgg) or hidden layers (mlp)
    num_classes: int = 10
    image_hw: int = 16
    in_channels: int = 3
    groups: int = 4

    @property
    def num_blocks(self) -> int:
        return self.depth


def _normal(seed: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator(seed, device), device=device)


def _conv_init(seed: int, k: int, cin: int, cout: int, device) -> torch.Tensor:
    """HWIO kernel, N(0, 2 / fan) with fan = k * k * cin."""
    fan = k * k * cin
    return _normal(seed, (k, k, cin, cout), device) * (2.0 / fan) ** 0.5


def _dense(seed: int, cin: int, cout: int, device) -> dict:
    return {"w": _normal(seed, (cin, cout), device) * cin ** -0.5,
            "b": torch.zeros((cout,), device=device)}


def _gn_init(c: int, device) -> dict:
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def init_classifier(seed: int, cfg: ClassifierConfig,
                    device: DeviceLike = "cuda") -> Tree:
    """float32 parameters on ``device`` (the card unless the caller asks
    for the CPU).  Seeds follow the reference's keys: ``fold_in(seed, 0)``
    for the embedding, ``fold_in(seed, i + 1)`` for block i (folded again
    with 0, 1, 2 for its convs), ``fold_in(seed, depth + 2)`` for the
    head; the numbers are not ``jax.random``'s."""
    dev = resolve_device(device)
    head_seed = fold_in(seed, cfg.depth + 2)
    if cfg.kind == "mlp":
        d_in = cfg.image_hw * cfg.image_hw * cfg.in_channels
        return {
            "embed": _dense(fold_in(seed, 0), d_in, cfg.width, dev),
            "blocks": [_dense(fold_in(seed, i + 1), cfg.width, cfg.width, dev)
                       for i in range(cfg.depth)],
            "head": _dense(head_seed, cfg.width, cfg.num_classes, dev),
        }
    if cfg.kind not in ("resnet", "vgg"):
        raise ValueError(f"unknown classifier kind {cfg.kind!r}")

    w = cfg.width
    stem = {"conv": _conv_init(fold_in(seed, 0), 3, cfg.in_channels, w, dev),
            "gn": _gn_init(w, dev)}
    blocks: List[dict] = []
    cin = w
    for i in range(cfg.depth):
        cout = w * (2 ** i)
        ks = fold_in(seed, i + 1)
        blk = {"conv1": _conv_init(fold_in(ks, 0), 3, cin, cout, dev),
               "gn1": _gn_init(cout, dev)}
        if cfg.kind == "resnet":
            blk["conv2"] = _conv_init(fold_in(ks, 1), 3, cout, cout, dev)
            blk["gn2"] = _gn_init(cout, dev)
            if cin != cout:
                blk["proj"] = _conv_init(fold_in(ks, 2), 1, cin, cout, dev)
        blocks.append(blk)
        cin = cout
    return {"embed": stem, "blocks": blocks,
            "head": _dense(head_seed, cin, cfg.num_classes, dev)}


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(p: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution: x (B, H, W, Cin) NHWC, p (k, k, Cin, Cout)
    HWIO -> (B, H', W', Cout) NHWC with H' = ceil(H / stride)."""
    if p.shape[:2] == (1, 1):
        # "SAME" pads a 1x1 kernel by nothing at any stride: a product
        # over channels of every stride-th pixel (the CPU backward of a
        # strided 1x1 F.conv2d on a channels-last view crashes, torch 2.13)
        return x[:, ::stride, ::stride] @ p[0, 0]
    (top, bottom), (left, right) = (_same_pads(x.shape[1], p.shape[0], stride),
                                    _same_pads(x.shape[2], p.shape[1], stride))
    xc, wc = x.permute(0, 3, 1, 2), p.permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def groupnorm(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """GroupNorm of x (B, H, W, C) over ``min(groups, C)`` groups of
    consecutive channels: the biased variance, ``rsqrt(var + 1e-5)``, then
    the per-channel scale and bias."""
    g = min(groups, x.shape[-1])
    y = F.group_norm(x.permute(0, 3, 1, 2), g, p["scale"], p["bias"], eps=1e-5)
    return y.permute(0, 2, 3, 1)


def apply_classifier(params: Tree, cfg: ClassifierConfig,
                     images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) float32 -> logits (B, num_classes)."""
    if cfg.kind == "mlp":
        x = images.reshape(images.shape[0], -1)  # NHWC order, as the reference
        x = torch.relu(x @ params["embed"]["w"] + params["embed"]["b"])
        for blk in params["blocks"]:
            x = torch.relu(x @ blk["w"] + blk["b"])
        return x @ params["head"]["w"] + params["head"]["b"]

    x = torch.relu(groupnorm(params["embed"]["gn"],
                             conv(params["embed"]["conv"], images), cfg.groups))
    for i, blk in enumerate(params["blocks"]):
        stride = 2 if i > 0 else 1
        h = torch.relu(groupnorm(blk["gn1"], conv(blk["conv1"], x, stride),
                                 cfg.groups))
        if cfg.kind == "resnet":
            h = groupnorm(blk["gn2"], conv(blk["conv2"], h), cfg.groups)
            skip = conv(blk["proj"], x, stride) if "proj" in blk else x
            h = torch.relu(h + skip)
        x = h
    x = torch.mean(x, dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]
