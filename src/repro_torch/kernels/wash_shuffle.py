"""The Hopper WASH-shuffle kernels: their build, ctypes bindings and launch
counters.

Replace ``repro/kernels/wash_shuffle.py`` ``wash_shuffle_pallas`` (the
dense apply) and ``bucketed_shuffle_pallas`` (the bucketed apply).  The
source is ``csrc/wash_shuffle.cu`` (its head says what bounds the kernels
and what the design does about it), built at first use by
``kernels/build.py``.  Nothing is compiled or loaded when this module is
imported.

The dense kernel takes a table of up to :data:`MAX_LEAVES` leaves of one
word size a launch: :func:`wash_shuffle_many_cuda_` shuffles a step's
leaves in place in one launch a word size (:func:`plan_launches` packs
the table, in plain Python), :func:`wash_shuffle_cuda` one leaf into a
new tensor.  The wrappers take CUDA tensors only; the CPU paths of
``kernels.ops.wash_shuffle`` / ``wash_shuffle_many_`` /
``bucketed_shuffle`` never reach this module's build.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as _build

#: launches of the dense kernel made through :func:`wash_shuffle_cuda` and
#: :func:`wash_shuffle_many_cuda_`
wash_launches = 0

#: leaves those launches shuffled
wash_leaves = 0

#: launches of the bucketed kernel made through :func:`bucketed_shuffle_cuda_`
bucketed_launches = 0

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "wash_shuffle.cu"

MAX_MEMBERS = 16  # kMaxN in the source
THREADS = 256     # kThreads: threads a block, a column or a vector each
MAX_LEAVES = 64   # kMaxLeaves: leaves a dense launch
VECTOR_BYTES = 16  # kVecBytes: bytes of a row a thread moves on the vector path

#: element types the kernels move (as 2- or 4-byte words, bit for bit)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_lib = None


class _Leaf(ctypes.Structure):
    """The source's ``Leaf``: one leaf of a dense launch, 48 bytes."""
    _fields_ = [("out", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("perm", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("d", ctypes.c_longlong), ("first_block", ctypes.c_int),
                ("n", ctypes.c_int16), ("vector", ctypes.c_int16)]


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_wash_shuffle_many.restype = ci
    lib.repro_wash_shuffle_many.argtypes = [ci, vp, ci, ci, vp]
    lib.repro_bucketed_shuffle.restype = ci
    lib.repro_bucketed_shuffle.argtypes = [ci, vp, vp, ci, ll, ll, vp]
    lib.repro_wash_shuffle_attributes.restype = ci
    lib.repro_wash_shuffle_attributes.argtypes = [ci, ci, ctypes.POINTER(ci)]
    _lib = lib
    return lib


def kernel_attributes(elt_bytes: int, rows: int) -> dict:
    """What the compiler gave the dense kernel for ``elt_bytes``-byte words
    and up to ``rows`` members (2, 4, 8 or 16): registers a thread, static
    shared and local (stack and spill) bytes, and its parameter bytes (the
    leaf table).  Builds the library if needed; launches nothing."""
    out = (ctypes.c_int * 4)()
    rc = build().repro_wash_shuffle_attributes(elt_bytes, rows, out)
    if rc != 0:
        raise RuntimeError(f"wash shuffle attributes: CUDA error {rc}")
    return {"registers": out[0], "shared_bytes": out[1],
            "local_bytes": out[2], "param_bytes": out[3]}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wash shuffle kernel: {msg}")


def _check_leaf(x: torch.Tensor) -> None:
    _check(x.is_cuda, "x must be a CUDA tensor")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be contiguous (N, D)")
    _check(x.dtype in DTYPES, f"x dtype {x.dtype} not in {list(DTYPES)}")
    _check(1 <= x.shape[0] <= MAX_MEMBERS,
           f"N={x.shape[0]} members; the kernel takes 1..{MAX_MEMBERS}")


def _check_plan(x: torch.Tensor, perm: torch.Tensor, mask: torch.Tensor):
    n, d = x.shape
    _check(perm.device == x.device and mask.device == x.device,
           "x, perm and mask must be on one CUDA device")
    _check(perm.dtype == torch.int32 and perm.shape == (n, d)
           and perm.is_contiguous(), "perm must be contiguous int32 (N, D)")
    _check(mask.dtype == torch.bool and mask.shape == (d,)
           and mask.is_contiguous(), "mask must be contiguous bool (D,)")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def vector_words(elt: int) -> int:
    """Words of ``elt`` bytes a thread moves a row on the vector path."""
    return VECTOR_BYTES // elt


def takes_vector_path(elt: int, d: int, out_ptr: int, x_ptr: int,
                      perm_ptr: int, mask_ptr: int) -> bool:
    """Whether every row of a leaf starts on 16 bytes: the rows of x, out
    and perm (D a multiple of the vector's words, their bases on 16
    bytes) and the mask's words (its base on a word of the vector's
    columns)."""
    vw = vector_words(elt)
    return (d % vw == 0 and all(p % VECTOR_BYTES == 0
                                for p in (out_ptr, x_ptr, perm_ptr))
            and mask_ptr % vw == 0)


def leaf_blocks(elt: int, d: int, vector: bool) -> int:
    """Blocks of the dense kernel for a leaf of D columns: a thread a
    vector of :func:`vector_words` columns, or a column."""
    items = d // vector_words(elt) if vector else d
    return -(-items // THREADS)


class Launch(NamedTuple):
    """One dense launch: its word size, its leaves (indices into the
    call's list, in order) with their first blocks, and its blocks."""
    elt: int
    leaves: Tuple[int, ...]
    first_blocks: Tuple[int, ...]
    blocks: int


def plan_launches(leaves: Sequence[Tuple[int, int, bool]]) -> List[Launch]:
    """Pack leaves ``(elt bytes, D, vector path)`` into dense launches:
    grouped by word size (in the order each size first appears), at most
    :data:`MAX_LEAVES` a launch in the call's order, each leaf's first
    block the blocks of the leaves before it in its launch.  A leaf of no
    columns gets no place."""
    groups: Dict[int, List[int]] = {}
    for i, (elt, d, _) in enumerate(leaves):
        if d > 0:
            groups.setdefault(elt, []).append(i)
    launches = []
    for elt, idx in groups.items():
        for k in range(0, len(idx), MAX_LEAVES):
            part = tuple(idx[k:k + MAX_LEAVES])
            firsts, total = [], 0
            for i in part:
                firsts.append(total)
                total += leaf_blocks(elt, leaves[i][1], leaves[i][2])
            launches.append(Launch(elt, part, tuple(firsts), total))
    return launches


def _launch_dense(outs, xs, perms, masks) -> int:
    """Launch the dense kernel over the leaves (out, x, perm, mask);
    returns the launches made."""
    global wash_launches, wash_leaves
    vec = [takes_vector_path(x.element_size(), x.shape[1], o.data_ptr(),
                             x.data_ptr(), p.data_ptr(), m.data_ptr())
           for o, x, p, m in zip(outs, xs, perms, masks)]
    launches = plan_launches([(x.element_size(), x.shape[1], v)
                              for x, v in zip(xs, vec)])
    if not launches:
        return 0
    lib = build()
    stream = _stream(xs[0])
    for ln in launches:
        table = (_Leaf * len(ln.leaves))()
        for slot, (i, first) in enumerate(zip(ln.leaves, ln.first_blocks)):
            x = xs[i]
            table[slot] = _Leaf(outs[i].data_ptr(), x.data_ptr(),
                                perms[i].data_ptr(), masks[i].data_ptr(),
                                x.shape[1], first, x.shape[0],
                                1 if vec[i] else 0)
        rc = lib.repro_wash_shuffle_many(ln.elt, ctypes.addressof(table),
                                         len(ln.leaves), ln.blocks, stream)
        if rc != 0:
            raise RuntimeError(f"wash shuffle kernel launch failed: CUDA "
                               f"error {rc}")
        wash_launches += 1
        wash_leaves += len(ln.leaves)
    return len(launches)


def wash_shuffle_cuda(x: torch.Tensor, perm: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Dense WASH apply; same contract as ``kernels.ref.wash_shuffle_ref``.

      x    : (N, D) float32, bfloat16 or float16, contiguous, N <= 16
      perm : (N, D) int32, contiguous; where the mask is set each column
             holds a permutation of range(N) (other columns are not read;
             an entry outside [0, N) fails the kernel with a trap)
      mask : (D,) bool, contiguous

    Returns a new contiguous (N, D) tensor: one launch, one leaf."""
    _check_leaf(x)
    _check_plan(x, perm, mask)
    out = torch.empty_like(x)
    _launch_dense([out], [x], [perm], [mask])
    return out


def wash_shuffle_many_cuda_(xs: Sequence[torch.Tensor],
                            perms: Sequence[torch.Tensor],
                            masks: Sequence[torch.Tensor]):
    """Dense WASH apply on many leaves **in place**, one launch a word size
    and up to :data:`MAX_LEAVES` leaves (:func:`plan_launches`): each
    ``(xs[i], perms[i], masks[i])`` as :func:`wash_shuffle_cuda` takes
    them, every tensor on one CUDA device.  Returns ``xs``."""
    _check(len(xs) == len(perms) == len(masks),
           "xs, perms and masks must be equally long")
    for x, perm, mask in zip(xs, perms, masks):
        _check_leaf(x)
        _check_plan(x, perm, mask)
        _check(x.device == xs[0].device, "every leaf must be on one device")
    _launch_dense(xs, xs, perms, masks)
    return xs


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
