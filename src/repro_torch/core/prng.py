"""Shared-randomness discipline for population training.

Port of ``repro/core/prng.py``.  WASH needs every member to agree on which
coordinates are shuffled this step and on the permutation of each; the
reference derives everything from a shared base key folded with the step
index and then with a stable per-leaf index.  The port does the same with
integer seeds: :func:`fold_in` mixes a seed with a number (SplitMix64), and
:func:`generator` turns a seed into a ``torch.Generator`` on a device.
The numbers differ from ``jax.random``'s for the same seed; tests that
compare the two packages carry JAX's plans and data across as arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finalizer: a bijection of 64-bit integers."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (as ``jax.random.fold_in``
    derives a key)."""
    z = _mix64((seed & _MASK) + 0x9E3779B97F4A7C15 * ((data & _MASK) + 1)
               & _MASK)
    return z >> 1


def step_seed(base_seed: int, step: int) -> int:
    """Seed shared by all members for a given training step."""
    return fold_in(base_seed, step)


def leaf_seed(seed: int, leaf_index: int) -> int:
    """Per-leaf seed derived from the shared step seed."""
    return fold_in(seed, leaf_index)


def stream_seed(seed: int, step: int) -> int:
    """The generator seed of one (request, step) of a sample stream: a hash
    of both, so a request's draws depend on nothing else in its batch."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0])


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
