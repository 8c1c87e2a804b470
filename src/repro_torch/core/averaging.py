"""Weight soups and ensemble logit averaging.

Port of ``repro/core/averaging.py`` (``balanced_mean`` and
``uniform_soup``).  Both use the reference's fixed pairwise-sum tree
followed by one divide, so in float32 the result is bitwise the JAX one.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.population import tree_map

Tree = Any


def balanced_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 as a fixed balanced pairwise-sum tree.

    Same arithmetic DAG as the reference: adjacent rows are summed pair by
    pair (an odd row carries up unchanged) until one row is left, then it
    is divided by N once."""
    rows = [x[i] for i in range(x.shape[0])]
    n = len(rows)
    while len(rows) > 1:
        nxt = [rows[i] + rows[i + 1] for i in range(0, len(rows) - 1, 2)]
        if len(rows) % 2:
            nxt.append(rows[-1])
        rows = nxt
    return rows[0] / n


def uniform_soup(stacked: Tree) -> Tree:
    """Uniform weight soup θ̄ = (1/N) Σ θ_n, leafwise :func:`balanced_mean`."""
    return tree_map(balanced_mean, stacked)
