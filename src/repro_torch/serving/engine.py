"""Serving modes and the params each one serves.

Port of the mode routing of ``repro/serving/engine.py`` (``MODES``,
``averaged_params``, ``serving_params``).  The scan engine itself
(``generate``, ``decode_scan``) is not ported yet.

  soup      uniform weight average of the population — single-model cost
            (the paper's "Averaged").
  member    member *i* unaveraged.
  ensemble  every member decodes, logits averaged (``averaging.balanced_mean``)
            before sampling — N× the cost.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core import averaging
from repro_torch.core import population as pop

Tree = Any

MODES = ("soup", "member", "ensemble")


def averaged_params(trained: Any) -> Tree:
    """The uniform soup of a stacked population (or of an object with a
    ``.population`` attribute)."""
    population = getattr(trained, "population", trained)
    return averaging.uniform_soup(population)


def serving_params(trained: Any, mode: str = "soup", member: int = 0) -> Tree:
    """soup → averaged member; member → member *i* (views, no copy);
    ensemble → the stacked population as it is."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; expected one of {MODES}")
    population = getattr(trained, "population", trained)
    if mode == "soup":
        return averaged_params(population)
    if mode == "member":
        return pop.member(population, member)
    return population
