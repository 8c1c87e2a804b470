"""Per-leaf layer indices for the layer-wise probability schedule (Eq. 6).

Port of ``repro/core/layer_index.py`` (``leaf_depth``, ``infer_layer_ids``,
``total_layers``, the stage arithmetic of the pipeline's plans and
accounting, ``stage_layer_bounds`` and ``stage_of_depth``, and the
``depth_histogram`` diagnostic).  Every parameter gets a depth l in
[0, L-1]:

  * token/patch/frame embeddings            -> depth 0
  * transformer block i (or conv stage i)   -> depth i + 1
  * final norm / lm head / classifier head  -> depth L_total - 1

Depths come from tree paths (:func:`repro_torch.core.population.tree_paths`,
which visits leaves in JAX's order): a leaf whose path holds the key
``blocks`` (or ``enc_blocks``/``dec_blocks``/``stages``) followed by a
sequence index i gets depth i+1; paths naming an embedding get 0;
everything else gets the maximum depth.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np

from repro_torch.core.population import tree_map, tree_paths

Tree = Any

_BLOCK_KEYS = ("blocks", "enc_blocks", "dec_blocks", "stages")
_EMBED_RE = re.compile(r"(embed|patch_proj|frame_proj|conv_in|tok_)")


def leaf_depth(path: Sequence, num_blocks: int) -> int:
    """Depth in [0, L-1] with L = num_blocks + 2 (embed + blocks + head).
    ``path`` holds dict keys (str) and sequence indices (int)."""
    entries = list(path)
    l_total = num_blocks + 2
    for i, e in enumerate(entries):
        if isinstance(e, str) and e in _BLOCK_KEYS:
            nxt = entries[i + 1] if i + 1 < len(entries) else None
            if isinstance(nxt, int):
                return min(nxt + 1, l_total - 1)
            m = re.search(r"(\d+)$", str(nxt)) if nxt is not None else None
            if m:
                return min(int(m.group(1)) + 1, l_total - 1)
    joined = "/".join(str(e) for e in entries).lower()
    if _EMBED_RE.search(joined):
        return 0
    return l_total - 1


def _is_scanned_blocks(path: Sequence, leaf, num_blocks: int) -> bool:
    """True for stacked-block leaves: the path hits a block key with no
    per-layer sequence index, and the leading dim equals num_blocks."""
    entries = list(path)
    for i, e in enumerate(entries):
        if isinstance(e, str) and e in _BLOCK_KEYS:
            nxt = entries[i + 1] if i + 1 < len(entries) else None
            if not isinstance(nxt, int):
                return (hasattr(leaf, "shape") and len(leaf.shape) > 0
                        and leaf.shape[0] == num_blocks)
    return False


def infer_layer_ids(params: Tree, num_blocks: int) -> Tree:
    """Tree (same structure as ``params``) of depths.

    Leaves are ints, except stacked-block leaves (one leaf spans all
    blocks along axis 0), which get an ``np.arange`` depth vector so the
    Eq. 6 schedule stays per-layer exact."""
    depths = []
    for path, leaf in tree_paths(params):
        if _is_scanned_blocks(path, leaf, num_blocks):
            depths.append(np.arange(1, num_blocks + 1))
        else:
            depths.append(leaf_depth(path, num_blocks))
    it = iter(depths)
    return tree_map(lambda _: next(it), params)


def total_layers(num_blocks: int) -> int:
    return num_blocks + 2


def stage_layer_bounds(num_blocks: int, num_stages: int):
    """Contiguous ``[lo, hi)`` block ranges per pipeline stage: stage ``s``
    owns blocks ``[s*L//S, (s+1)*L//S)`` (uneven counts allowed)."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    return tuple((s * num_blocks // num_stages,
                  (s + 1) * num_blocks // num_stages)
                 for s in range(num_stages))


def stage_of_depth(depth: int, num_blocks: int, num_stages: int) -> int:
    """Owner stage of a leaf by its depth: embeddings on stage 0, the final
    norm and head on the last, block ``b`` (depth ``b + 1``) on the stage
    whose :func:`stage_layer_bounds` range holds it."""
    if depth <= 0:
        return 0
    if depth >= num_blocks + 1:
        return num_stages - 1
    b = depth - 1
    for s, (lo, hi) in enumerate(stage_layer_bounds(num_blocks, num_stages)):
        if lo <= b < hi:
            return s
    return num_stages - 1


def depth_histogram(params: Tree, num_blocks: int) -> dict:
    """Diagnostic: the scalar count at each depth (:func:`leaf_depth` of
    each leaf's path; a stacked-blocks leaf counts whole at the depth its
    path gives)."""
    hist: dict = {}
    for path, leaf in tree_paths(params):
        d = leaf_depth(path, num_blocks)
        size = int(np.prod(tuple(leaf.shape), dtype=np.int64))
        hist[d] = hist.get(d, 0) + size
    return hist
