"""npz checkpoints in the JAX package's format.

Port of ``repro/train/checkpoint.py``: one array per leaf, keyed by the
leaf's tree path joined with ``::`` (dict keys in sorted order, sequence
indices as numbers), so a population written by either package restores
in the other.  bfloat16 leaves are stored as raw 2-byte records (``|V2``),
as ``np.savez`` stores a JAX bfloat16 array; :func:`restore` reads them
as bfloat16 bit patterns and takes each leaf's dtype from the template.
Restored onto a pipeline stage's layout (``stage=(s, S)``), a ``blocks``
leaf of the template that holds L/S layers reads its stage's rows of the
file's L, so the stage's device never holds the whole member (the
reference places each leaf onto its template's sharding).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.population import tree_map, tree_paths
from repro_torch.train.interop import tensor_from_numpy, tensor_to_numpy

Tree = Any
_SEP = "::"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def save(path: str, tree: Tree) -> str:
    """Write ``tree`` as an npz archive and return the path written
    (``.npz`` is appended when missing, as numpy would)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{_key(p): tensor_to_numpy(leaf)
                      for p, leaf in tree_paths(tree)})
    return path


def _stage_rows(path, arr, leaf, stage):
    """``arr``'s rows of stage ``stage = (s, S)`` along the one dim where
    ``leaf`` (a ``blocks`` leaf) holds 1/S of the file's layers; None when
    the shapes do not differ that way."""
    diff = [d for d, (a, b) in enumerate(zip(arr.shape, leaf.shape))
            if a != b]
    if (stage is None or len(diff) != 1 or arr.ndim != len(leaf.shape)
            or "blocks" not in path):
        return None
    s, stages = stage
    d, n = diff[0], int(leaf.shape[diff[0]])
    if arr.shape[d] != n * stages:
        return None
    return arr[(slice(None),) * d + (slice(s * n, (s + 1) * n),)]


def restore(path: str, like: Tree,
            device: Optional[DeviceLike] = None,
            stage: Optional[Tuple[int, int]] = None) -> Tree:
    """Restore into the structure of ``like`` (shapes must match).

    Each leaf takes its dtype from ``like``, and lands on ``device`` or,
    when that is None, on the ``like`` leaf's device.  ``like`` may be a
    tree of ``meta`` tensors (``models.transformer.param_shapes``), which
    then needs ``device``.  With ``stage=(s, S)``, a ``blocks`` leaf of
    ``like`` whose layer dim holds L/S of the file's L layers restores
    rows [s·L/S, (s+1)·L/S) of it; any other shape mismatch is an
    error."""
    dev = resolve_device(device) if device is not None else None
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        def load(p, leaf):
            key = _key(p)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                rows = _stage_rows(p, arr, leaf, stage)
                if rows is None:
                    raise ValueError(
                        f"{key}: {arr.shape} != {tuple(leaf.shape)}")
                arr = np.ascontiguousarray(rows)
            target = dev if dev is not None else leaf.device
            if target.type == "meta":
                raise ValueError("restore into a meta template needs device=")
            return tensor_from_numpy(arr, target, leaf.dtype)

        leaves = iter([load(p, leaf) for p, leaf in tree_paths(like)])
    # tree_map visits leaves in tree_paths' order
    return tree_map(lambda _: next(leaves), like)
