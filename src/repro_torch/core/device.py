"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through :func:`resolve_device`, which raises when no card is present
instead of running on the CPU behind the caller's back.  ``"meta"`` is
the dry run's device (``launch/dryrun.py``): shapes and dtypes only,
nothing allocated, no card needed.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in (so it
    compares equal to a tensor's ``.device``)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type in ("cpu", "meta"):
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
