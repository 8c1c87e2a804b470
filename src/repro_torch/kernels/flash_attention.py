"""The Hopper flash-attention kernel: its build, its ctypes binding and its
launch counter.

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas``.
The source is ``csrc/flash_attention.cu`` (its head says what bounds the
kernels and what their designs do about it: bf16 on the tensor cores
through wgmma with TMA-fed tiles, float32 on the tensor cores through
3xTF32 mma.sync with cp.async-fed tiles), with the PTX helpers of
``csrc/sm90.cuh``, built at first use by
``kernels/build.py``.  Nothing is compiled or loaded when this module is
imported.

:func:`flash_attention_cuda` takes CUDA tensors only; the CPU path of
``kernels.ops.flash_attention`` never reaches this module's build.
"""

from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

#: kernel launches made through :func:`flash_attention_cuda`
launches = 0

#: the same launches by (dtype, B, S, H, KV, hd, hd_v, causal, window)
launch_shapes: collections.Counter = collections.Counter()

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: the (q/k, v) head-width pairs the source instantiates: the square ones,
#: and MLA's 192-wide queries and keys (128 + 64 rope) with 128-wide values
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))

_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.repro_flash_attention.restype = ci
    lib.repro_flash_attention.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci,
                                          ci, ci, ci, ci, ctypes.c_float, vp]
    lib.repro_flash_attention_attributes.restype = ci
    lib.repro_flash_attention_attributes.argtypes = [ci, ci, ci,
                                                     ctypes.POINTER(ci)]
    _lib = lib
    return lib


def kernel_attributes(dtype: torch.dtype, hd: int,
                      hd_v: Optional[int] = None) -> dict:
    """What the compiler gave the kernel a call with this dtype and (q/k,
    v) head widths launches (``hd_v`` defaults to ``hd``): registers a
    thread, static and dynamic shared bytes, local (stack and spill)
    bytes.  Builds the library if needed; launches nothing."""
    out = (ctypes.c_int * 4)()
    rc = build().repro_flash_attention_attributes(
        _CODES[dtype], hd, hd if hd_v is None else hd_v, out)
    if rc != 0:
        raise RuntimeError(f"flash attention attributes: CUDA error {rc}")
    return {"registers": out[0], "shared_bytes": out[1],
            "local_bytes": out[2], "dynamic_shared_bytes": out[3]}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on the current stream; same contract as
    ``kernels.ref.flash_attention_ref``.

      q     : (B, S, H, hd) float32 or bfloat16, contiguous, starting on
              a 16-byte boundary (the kernels copy 16-byte pieces)
      k     : (B, S, KV, hd), q's dtype, contiguous, H a multiple of KV
      v     : (B, S, KV, hd_v), likewise; (hd, hd_v) in :data:`HEAD_DIMS`
      window: None, or the sliding window (>= 1 keys, the query's own
              included)

    Scores are scaled by ``hd**-0.5`` (the q/k width).  Returns a new
    contiguous (B, S, H, hd_v) tensor in q's dtype."""
    global launches
    _check(all(t.is_cuda and t.device == q.device for t in (q, k, v)),
           "q, k and v must be on one CUDA device")
    _check(q.dtype in _CODES, f"dtype {q.dtype} not in {list(_CODES)}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
           and k.shape[:3] == v.shape[:3],
           "q must be (B, S, H, hd), k (B, S, KV, hd) and v (B, S, KV, hd_v)")
    B, S, H, hd = q.shape
    KV, hd_v = k.shape[2], v.shape[3]
    _check(k.shape[0] == B and k.shape[1] == S and k.shape[3] == hd,
           f"k shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _check(KV > 0 and H % KV == 0, f"H={H} is not a multiple of KV={KV}")
    _check((hd, hd_v) in HEAD_DIMS,
           f"(q/k, v) head dims {(hd, hd_v)} not in {HEAD_DIMS}")
    _check(all(t.is_contiguous() for t in (q, k, v)),
           "q, k and v must be contiguous")
    _check(window is None or window >= 1, f"window={window} must be >= 1")
    _check(min(B, S, H) >= 1, f"empty input {tuple(q.shape)}")
    _check(B * H * -(-S // 64) < 2 ** 31, "too many blocks")
    out = q.new_empty((B, S, H, hd_v))
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)),
           "q, k, v and out must start on a 16-byte boundary (the kernels "
           "copy 16-byte pieces: TMA in bf16, cp.async in f32)")
    lib = build()
    rc = lib.repro_flash_attention(
        _CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, hd_v, int(bool(causal)),
        0 if window is None else int(window), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    launch_shapes[(q.dtype, B, S, H, KV, hd, hd_v, bool(causal), window)] += 1
    return out
