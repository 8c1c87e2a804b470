"""The Hopper paged-attention kernel: its build, its ctypes binding and its
launch counter.

Replaces ``repro/kernels/paged_attention.py`` ``paged_attention_pallas``.
The source is ``csrc/paged_attention.cu`` (its head says what bounds the
kernel and what the design does about it: each slot's context split across
blocks, 16-byte loads, a second kernel that merges the splits).  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
entry point, at first use, into ``build/repro_torch_kernels/`` at the
repository root, by ``kernels/build.py``.  Nothing is compiled or loaded
when this module is imported.

:func:`paged_attention_cuda` takes CUDA tensors only; the CPU path of
``kernels.ops.paged_attention`` never reaches this module's build.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build

#: calls of :func:`paged_attention_cuda` that launched its kernels (one
#: call is two launches: the splits, then their merge)
launches = 0

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

MAX_GROUP = 8        # kMaxG in the source
MAX_HEAD_DIM = 128   # kMaxHd in the source
SPLIT_TOKENS = 128   # tokens of a slot's context one block takes (at most)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    fn = lib.repro_paged_attention
    fn.restype = ctypes.c_int
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ci, ci, vp, vp, vp, ll, ll, ll, ll, ll, ll, ll, ll,
                   vp, ll, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                   ci, ci, ci, ci, ctypes.c_float, vp]
    lib.repro_paged_attention_attributes.restype = ci
    lib.repro_paged_attention_attributes.argtypes = [
        ci, ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
    _lib = lib
    return lib


def kernel_attributes(q_dtype: torch.dtype, kv_dtype: torch.dtype, H: int,
                      KV: int, hd: int, vec: int) -> dict:
    """What the compiler gave the split kernel that a call with these
    types and shapes launches (the variant :func:`load_width` picked as
    ``vec``): registers a thread, static shared and local (stack and
    spill) bytes.  Builds the library if needed; launches nothing."""
    out = (ctypes.c_int * 3)()
    rc = build().repro_paged_attention_attributes(
        _Q_CODES[q_dtype], _KV_CODES[kv_dtype], H, KV, hd, vec, out)
    if rc != 0:
        raise RuntimeError(f"paged attention attributes: CUDA error {rc}")
    return {"registers": out[0], "shared_bytes": out[1],
            "local_bytes": out[2]}


def split_of(page_size: int, max_pages: int) -> Tuple[int, int]:
    """``(split_tokens, n_split)``: whole pages of at most
    :data:`SPLIT_TOKENS` tokens per block, and as many splits as the page
    table's width needs.  From shapes alone, so the host never reads
    ``lengths``."""
    pages = max(1, SPLIT_TOKENS // page_size)
    return pages * page_size, -(-max_pages // pages)


def load_width(k_pool: torch.Tensor, v_pool: torch.Tensor, group: int) -> int:
    """Elements of a K/V row one lane loads at once: 16 bytes' worth (8
    bytes for int8 pools at a group of more than 4 query rows, where 16
    would spill the registers), when hd is a whole number of such runs
    that divides a warp, the head dim is the unit-stride axis and every
    other stride and both pools' start are aligned to the run; else 1,
    the narrow variant of the same kernel."""
    elt = k_pool.element_size()
    vec = 8 if elt == 1 and group > 4 else 16 // elt
    hd = k_pool.shape[-1]
    lanes = hd // vec
    ok = hd % vec == 0 and lanes <= 32 and 32 % lanes == 0
    for pool in (k_pool, v_pool):
        p, t, h, d = pool.stride()
        ok = ok and d == 1 and p % vec == 0 and t % vec == 0 \
            and h % vec == 0 and pool.data_ptr() % (vec * elt) == 0
    return vec if ok else 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the kernel on the current stream; same contract as
    ``kernels.ref.paged_attention_ref``.

      q          : (B, H, hd) float32 or bfloat16, contiguous
      k/v_pool   : (P, page_size, KV, hd) float32, bfloat16 or int8, any
                   strides (a per-layer view ``pool[l]`` is read in place)
      page_table : (B, max_pages) int32, unit stride along pages
      lengths    : (B,) int32, contiguous, each >= 1; table entries below
                   ``ceil(length / page_size)`` must be valid page ids
      k/v_scale  : (P,) float32, contiguous; both for int8 pools, else
                   neither

    Returns a new contiguous (B, H, hd) tensor in q's dtype.  One call
    is two launches (each slot's context split across blocks, then the
    merge of the splits) and counts once in :data:`launches`.
    """
    global launches
    _check((k_scale is None) == (v_scale is None),
           "pass both k_scale and v_scale, or neither")
    tensors = [q, k_pool, v_pool, page_table, lengths]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    _check(all(t.is_cuda and t.device == q.device for t in tensors),
           "every tensor must be on one CUDA device")
    _check(q.dim() == 3 and q.is_contiguous(), "q must be contiguous (B, H, hd)")
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    B, H, hd = q.shape
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "k_pool and v_pool must share one (P, page_size, KV, hd) shape")
    _check(k_pool.dtype == v_pool.dtype and k_pool.dtype in _KV_CODES,
           f"pool dtype {k_pool.dtype} not in {list(_KV_CODES)}")
    P, page_size, KV, hd_p = k_pool.shape
    _check(hd_p == hd, f"pool head dim {hd_p} != q head dim {hd}")
    _check(KV > 0 and H % KV == 0, f"H={H} is not a multiple of KV={KV}")
    g = H // KV
    _check(g <= MAX_GROUP, f"group size {g} > {MAX_GROUP}")
    _check(hd <= MAX_HEAD_DIM, f"head dim {hd} > {MAX_HEAD_DIM}")
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == B and page_table.stride(1) == 1,
           "page_table must be int32 (B, max_pages) with unit stride")
    _check(lengths.dtype == torch.int32 and lengths.shape == (B,)
           and lengths.is_contiguous(), "lengths must be contiguous int32 (B,)")
    quantized = k_scale is not None
    _check(quantized == (k_pool.dtype == torch.int8),
           "int8 pools need k_scale/v_scale, other pools take none")
    if quantized:
        for s in (k_scale, v_scale):
            _check(s.dtype == torch.float32 and s.shape == (P,)
                   and s.is_contiguous(), "scales must be contiguous f32 (P,)")

    max_pages = page_table.shape[1]
    _check(max_pages >= 1, "the page table has no column")
    split_tokens, n_split = split_of(page_size, max_pages)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # each split's partial softmax state per query row (f32 scratch)
    m_part = torch.empty((B, H, n_split), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, n_split, hd), dtype=torch.float32,
                           device=q.device)
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_paged_attention(
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), *k_pool.stride(),
            *v_pool.stride(), page_table.data_ptr(), page_table.stride(0),
            lengths.data_ptr(), k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, m_part.data_ptr(),
            l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
            B, H, KV, hd, page_size, max_pages, split_tokens, n_split,
            load_width(k_pool, v_pool, g), hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
