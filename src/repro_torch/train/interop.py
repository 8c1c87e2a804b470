"""Parameters across the two packages: nested dicts of numpy arrays.

The JAX package's parameters reach the port as numpy (``np.asarray`` of
each leaf, or an ``.npz`` from ``repro.train.checkpoint``) and go back the
same way.  bfloat16 has no numpy dtype without ``ml_dtypes``: a bfloat16
leaf arrives either as ``ml_dtypes.bfloat16`` or, from ``np.load``, as raw
2-byte records (``|V2``); both are read as bfloat16 bit patterns.  Going
back, bfloat16 tensors become ``|V2`` arrays, the form ``np.savez`` gives
a JAX bfloat16 leaf.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.population import tree_map

Tree = Any

_BF16_BITS = np.dtype("V2")


def _is_bf16(arr: np.ndarray) -> bool:
    """True for a numpy array that holds bfloat16 values (either dtype)."""
    return arr.dtype.name == "bfloat16" or arr.dtype == _BF16_BITS


def tensor_from_numpy(arr: np.ndarray, device: DeviceLike = "cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def params_from_numpy(tree: Tree, device: DeviceLike = "cuda") -> Tree:
    """A tree of numpy arrays (any of JAX's leaf dtypes) as tensors on
    ``device``, each leaf in its own dtype (a bf16 model's float32 leaves,
    such as the MoE router, stay float32)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def params_to_numpy(tree: Tree) -> Tree:
    """A tree of tensors as numpy arrays on the host (bfloat16 as ``|V2``)."""
    return tree_map(tensor_to_numpy, tree)
