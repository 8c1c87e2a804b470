"""Layer-wise shuffle-probability schedules (paper Eq. 6 + Tab. 4 ablations).

Verbatim copy of ``repro/core/schedules.py`` (pure Python and numpy): the
port keeps its own copy of every module it needs.
"""

from __future__ import annotations


def layer_probability(
    base_p: float, depth: int, total_layers: int, schedule: str = "decreasing"
) -> float:
    """Shuffle probability for a parameter at ``depth`` in [0, L-1].

    decreasing : p_l = p * (1 - l/(L-1))   (paper default; last layer frozen)
    constant   : p_l = p
    increasing : p_l = p * l/(L-1)         (first layer frozen)
    """
    if total_layers <= 1:
        return base_p
    frac = depth / (total_layers - 1)
    if schedule == "decreasing":
        return base_p * (1.0 - frac)
    if schedule == "constant":
        return base_p
    if schedule == "increasing":
        return base_p * frac
    raise ValueError(f"unknown schedule {schedule!r}")


def layer_probability_array(base_p, depths, total_layers: int, schedule: str = "decreasing"):
    """Vectorized :func:`layer_probability` for stacked-block leaves.

    ``depths`` is an integer array (one depth per scanned layer); returns a
    float array of per-layer probabilities.
    """
    import numpy as np

    depths = np.asarray(depths, dtype=np.float64)
    if total_layers <= 1:
        return np.full_like(depths, base_p)
    frac = depths / (total_layers - 1)
    if schedule == "decreasing":
        return base_p * (1.0 - frac)
    if schedule == "constant":
        return np.full_like(depths, base_p)
    if schedule == "increasing":
        return base_p * frac
    raise ValueError(f"unknown schedule {schedule!r}")


def active_window(step: int, start_step: int, stop_step) -> bool:
    """Fig. 5b ablation: shuffle only inside [start_step, stop_step)."""
    if step < start_step:
        return False
    if stop_step is not None and step >= stop_step:
        return False
    return True
