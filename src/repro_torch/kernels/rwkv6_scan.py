"""The Hopper RWKV-6 WKV kernel: its build, its ctypes binding and its
launch counter.

Replaces ``repro/kernels/rwkv6_scan.py`` ``rwkv6_scan_pallas``, and takes
an initial state and returns the final one, which the model's time mix
carries from prefill into decode.  The source is ``csrc/rwkv6_scan.cu``
(its head says what bounds the kernel and what the design does about it),
built at first use by ``kernels/build.py``.  Nothing is compiled or
loaded when this module is imported.

A call with more than one step runs the chunked kernel: the sequence in
chunks of 16 steps in the chunked (matrix) form of the recurrence, the
state products on the tensor cores in 3xTF32, each head's key channels
split across a cluster of two blocks that exchange partial outputs;
``kernels.ref.rwkv6_scan_chunked_ref`` is a plain model of that
algorithm.  A one-step call (decode) runs a small step kernel.  Either
way one call is one launch.

:func:`rwkv6_scan_cuda` takes CUDA tensors only; the CPU path of
``kernels.ops.rwkv6_scan`` never reaches this module's build.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

#: kernel launches made through :func:`rwkv6_scan_cuda`
launches = 0

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"

HEAD_DIMS = (32, 64)  # the instantiations in the source

_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.repro_rwkv6_scan.restype = ci
    lib.repro_rwkv6_scan.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                     ci, ci, ci, vp]
    lib.repro_rwkv6_scan_attributes.restype = ci
    lib.repro_rwkv6_scan_attributes.argtypes = [ci, ci, ci,
                                                ctypes.POINTER(ci)]
    _lib = lib
    return lib


def kernel_attributes(dtype: torch.dtype, hd: int, steps: int) -> dict:
    """What the compiler gave the kernel a call with this dtype, head dim
    and number of steps launches (one step: the step kernel; more: the
    chunked kernel): registers a thread, static and dynamic shared bytes,
    local (stack and spill) bytes.  Builds the library if needed; launches
    nothing."""
    out = (ctypes.c_int * 4)()
    rc = build().repro_rwkv6_scan_attributes(_CODES[dtype], hd, steps, out)
    if rc != 0:
        raise RuntimeError(f"rwkv6 scan attributes: CUDA error {rc}")
    return {"registers": out[0], "shared_bytes": out[1],
            "local_bytes": out[2], "dynamic_shared_bytes": out[3]}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan_cuda: {msg}")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor,
                    state: Optional[torch.Tensor] = None):
    """Launch the kernel on the current stream; same contract as
    ``kernels.ref.rwkv6_scan_ref``.

      r, k, v, w : (B, T, H, hd) float32 or bfloat16 (one dtype),
                   contiguous, 16-byte aligned, hd in :data:`HEAD_DIMS`;
                   w the decay in [0, 1]
      u          : (H, hd) float32, contiguous, 16-byte aligned
      state      : None, or the initial state (B, H, hd, hd) float32,
                   contiguous

    Returns y, a new (B, T, H, hd) tensor in r's dtype; with a ``state``,
    ``(y, final_state)``, the final state a new float32 tensor."""
    global launches
    xs = (r, k, v, w)
    _check(all(t.is_cuda and t.device == r.device for t in xs + (u,)),
           "r, k, v, w and u must be on one CUDA device")
    _check(r.dtype in _CODES, f"dtype {r.dtype} not in {list(_CODES)}")
    _check(all(t.dtype == r.dtype for t in xs), "r, k, v, w must share a dtype")
    _check(r.dim() == 4 and all(t.shape == r.shape for t in xs),
           "r, k, v, w must share one (B, T, H, hd) shape")
    _check(all(t.is_contiguous() for t in xs), "r, k, v, w must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in xs + (u,)),
           "r, k, v, w and u must be 16-byte aligned")
    _check(state is None or state.data_ptr() % 16 == 0,
           "state must be 16-byte aligned")
    B, T, H, hd = r.shape
    _check(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _check(min(B, T, H) >= 1, f"empty input {tuple(r.shape)}")
    _check(B * H * hd < 2 ** 31 and T < 2 ** 31, "too large")
    _check(u.dtype == torch.float32 and u.shape == (H, hd)
           and u.is_contiguous(), "u must be contiguous float32 (H, hd)")
    if state is not None:
        _check(state.device == r.device and state.dtype == torch.float32
               and state.shape == (B, H, hd, hd) and state.is_contiguous(),
               "state must be contiguous float32 (B, H, hd, hd)")
    y = torch.empty_like(r)
    final = None if state is None else torch.empty_like(state)
    rc = build().repro_rwkv6_scan(
        _CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(),
        None if final is None else final.data_ptr(), y.data_ptr(), B, T, H,
        hd, torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y if state is None else (y, final)
