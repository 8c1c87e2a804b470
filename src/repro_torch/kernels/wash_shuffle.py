"""The Hopper WASH-shuffle kernels: their build, ctypes bindings and launch
counters.

Replace ``repro/kernels/wash_shuffle.py`` ``wash_shuffle_pallas`` (the
dense apply) and ``bucketed_shuffle_pallas`` (the bucketed apply).  The
source is ``csrc/wash_shuffle.cu`` (its head says what bounds the kernels
and what the design does about it), built at first use by
``kernels/build.py``.  Nothing is compiled or loaded when this module is
imported.

Both wrappers take CUDA tensors only; the CPU paths of
``kernels.ops.wash_shuffle`` / ``bucketed_shuffle`` never reach this
module's build.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

#: launches of the dense kernel made through :func:`wash_shuffle_cuda`
wash_launches = 0

#: launches of the bucketed kernel made through :func:`bucketed_shuffle_cuda_`
bucketed_launches = 0

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "wash_shuffle.cu"

MAX_MEMBERS = 16  # kMaxN in the source

#: element types the kernels move (as 2- or 4-byte words, bit for bit)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_lib = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_wash_shuffle.restype = ctypes.c_int
    lib.repro_wash_shuffle.argtypes = [ci, vp, vp, vp, vp, ci, ll, vp]
    lib.repro_bucketed_shuffle.restype = ctypes.c_int
    lib.repro_bucketed_shuffle.argtypes = [ci, vp, vp, ci, ll, ll, vp]
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wash shuffle kernel: {msg}")


def _check_leaf(x: torch.Tensor) -> None:
    _check(x.is_cuda, "x must be a CUDA tensor")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be contiguous (N, D)")
    _check(x.dtype in DTYPES, f"x dtype {x.dtype} not in {list(DTYPES)}")
    _check(1 <= x.shape[0] <= MAX_MEMBERS,
           f"N={x.shape[0]} members; the kernel takes 1..{MAX_MEMBERS}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def wash_shuffle_cuda(x: torch.Tensor, perm: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Dense WASH apply; same contract as ``kernels.ref.wash_shuffle_ref``.

      x    : (N, D) float32, bfloat16 or float16, contiguous, N <= 16
      perm : (N, D) int32, contiguous; where the mask is set each column
             holds a permutation of range(N) (other columns are not read;
             an entry outside [0, N) fails the kernel with a trap)
      mask : (D,) bool, contiguous

    Returns a new contiguous (N, D) tensor."""
    global wash_launches
    _check_leaf(x)
    n, d = x.shape
    _check(perm.device == x.device and mask.device == x.device,
           "x, perm and mask must be on one CUDA device")
    _check(perm.dtype == torch.int32 and perm.shape == (n, d)
           and perm.is_contiguous(), "perm must be contiguous int32 (N, D)")
    _check(mask.dtype == torch.bool and mask.shape == (d,)
           and mask.is_contiguous(), "mask must be contiguous bool (D,)")
    out = torch.empty_like(x)
    lib = build()
    rc = lib.repro_wash_shuffle(x.element_size(), x.data_ptr(),
                                perm.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), n, d, _stream(x))
    if rc != 0:
        raise RuntimeError(f"wash shuffle kernel launch failed: CUDA error {rc}")
    wash_launches += 1
    return out


def bucketed_shuffle_cuda_(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bucketed WASH apply **in place**; same contract as
    ``kernels.ref.bucketed_shuffle_ref_``.

      x   : (N, D) float32, bfloat16 or float16, contiguous, N <= 16;
            the selected columns are rewritten in place
      idx : (N, k_per) int32, contiguous, entries in [0, D), rows pairwise
            disjoint (as ``core.shuffle`` plans are by construction); an
            entry outside [0, D) fails the kernel with a trap (a CUDA
            error at the next synchronization), never a silent skip

    Returns ``x``."""
    global bucketed_launches
    _check_leaf(x)
    n, d = x.shape
    _check(idx.device == x.device, "x and idx must be on one CUDA device")
    _check(idx.dtype == torch.int32 and idx.dim() == 2 and idx.shape[0] == n
           and idx.is_contiguous(), "idx must be contiguous int32 (N, k_per)")
    lib = build()
    rc = lib.repro_bucketed_shuffle(x.element_size(), x.data_ptr(),
                                    idx.data_ptr(), n, d, idx.shape[1],
                                    _stream(x))
    if rc != 0:
        raise RuntimeError(f"bucketed shuffle kernel launch failed: CUDA "
                           f"error {rc}")
    bucketed_launches += 1
    return x
