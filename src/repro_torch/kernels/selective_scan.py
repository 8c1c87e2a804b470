"""The Hopper selective-scan (Mamba) kernels: their build, their ctypes
binding and their launch counters.

The TPU side has no kernel here: the reference runs the recurrence of
``repro/models/ssm.py`` ``_mamba_core`` as a ``lax.scan`` and lets XLA
differentiate it.  On the card that scan would be T dependent steps of
small launches in every hybrid layer, so the port computes it in a
hand-written kernel, forward and backward, from ``csrc/selective_scan.cu``
(its head says what bounds the kernels and what the design does about
it), built at first use by ``kernels/build.py``.  Nothing is compiled or
loaded when this module is imported.

:func:`selective_scan_cuda` is one launch a call, for any T, from a
carried state or from zero, writing the final state when asked: T = 1 (a
decode step) runs the step kernel, a longer T the chunked kernel, its
sequence cut into :func:`forward_segments` segments that walk at once in
one cluster and hop their ends through distributed shared memory.
:func:`selective_scan_bwd_cuda` is training's backward, two
launches a call, counted once a call in :data:`backward_launches`: the
sequence cut into at most :data:`SEGMENTS` segments of
:func:`segment_length` steps, one cluster of blocks a (batch, channel
block) that walks every segment at once and passes the segments' ends
through distributed shared memory; then a fixed-order reduction of the
channel blocks' and segments' partial sums.
``kernels.ref.selective_scan_ref`` and ``selective_scan_bwd_ref`` are the
plain versions they are held to; ``selective_scan_segmented_ref`` models
the forward's arithmetic, ``selective_scan_bwd_segmented_ref`` the
backward's.  Both take CUDA tensors only; the CPU path of
``kernels.ops.selective_scan`` never reaches this module's build.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import SSM_BWD_CHUNK

#: kernel launches made through :func:`selective_scan_cuda`
launches = 0

#: backward calls made through :func:`selective_scan_bwd_cuda`
backward_launches = 0

#: seconds the last build took (None until built in this process)
build_seconds: Optional[float] = None

#: what nvcc printed for the last build (ptxas register / smem report)
build_log = ""

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"

STATE_DIMS = (16,)  # the state sizes the source takes (``kS``)
CHANNELS = 16       # channels a backward block (``kCh``)
SEGMENTS = 8        # segments of a backward call at most, a cluster (``kSegs``)
MIN_CHUNKS = 4      # chunks a backward segment at least
THREADS = 128       # threads a backward block (``kThreads``)
# the longest segment: its chunks' (state, decay) pairs, 2 KB a chunk, and
# the block's 23 KB of static shared memory fit the 227 KB a block can take
MAX_SEGMENT = 96 * SSM_BWD_CHUNK
#: the longest sequence the backward takes (training's ``seq_len`` on the
#: card, ``models.transformer.cuda_supported``)
MAX_BACKWARD_T = SEGMENTS * MAX_SEGMENT

#: the kernels, in the order of ``kernel_attributes``' ``which``: the
#: forward, the backward's two launches (the segments, the reduction), the
#: forward's T = 1 step
KERNELS = ("selective_scan_fwd_kernel", "selective_scan_bwd_kernel",
           "selective_scan_bwd_reduce_kernel", "selective_scan_step_kernel")
#: the backward's kernels (a call launches both)
BACKWARD_KERNELS = KERNELS[1:3]

FWD_CHANNELS = 32   # channels a forward block (``kFwdCh``)
FWD_CHUNK = 32      # steps a forward stage (``kFwdChunk``)
SMS = 132           # the H100 SXM's streaming multiprocessors

_lib = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = _build.load(SOURCE)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.repro_selective_scan.restype = ci
    lib.repro_selective_scan.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.repro_selective_scan_step.restype = ci
    lib.repro_selective_scan_step.argtypes = [vp] * 8 + [ci] * 3 + [vp]
    lib.repro_selective_scan_bwd.restype = ci
    lib.repro_selective_scan_bwd.argtypes = [vp] * 17 + [ci] * 5 + [vp]
    lib.repro_selective_scan_attributes.restype = ci
    lib.repro_selective_scan_attributes.argtypes = [ci, ctypes.POINTER(ci)]
    _lib = lib
    return lib


def kernel_attributes(which: int) -> dict:
    """What the compiler gave kernel ``which`` (:data:`KERNELS`' index):
    registers a thread, static and dynamic shared bytes, local (stack and
    spill) bytes.  Builds the library if needed; launches nothing."""
    out = (ctypes.c_int * 4)()
    rc = build().repro_selective_scan_attributes(which, out)
    if rc != 0:
        raise RuntimeError(f"selective scan attributes ({KERNELS[which]}): "
                           f"CUDA error {rc}")
    return {"registers": out[0], "shared_bytes": out[1],
            "local_bytes": out[2], "dynamic_shared_bytes": out[3]}


def segment_length(T: int) -> int:
    """The backward's segment length for a sequence of T steps: as many
    segments as a power of two up to :data:`SEGMENTS` allows while each
    keeps at least :data:`MIN_CHUNKS` ``SSM_BWD_CHUNK``-step chunks, each
    as short as covers T.  Shorter segments spread a (batch, channel
    block) over more blocks; below four chunks a segment its fixed costs
    outweigh that (PERF.md)."""
    chunks = -(-T // SSM_BWD_CHUNK)
    n = 1
    while n < SEGMENTS and chunks >= 2 * n * MIN_CHUNKS:
        n *= 2
    return SSM_BWD_CHUNK * -(-chunks // n)


def forward_segment_length(T: int, nseg: int) -> int:
    """The forward's segment length for ``nseg`` segments of a T-step
    sequence: the fewest whole ``FWD_CHUNK``-step chunks that cover T in
    ``nseg`` segments (``ceil(T / length)`` of them are used)."""
    chunks = -(-T // FWD_CHUNK)
    return FWD_CHUNK * -(-chunks // nseg)


def forward_segments(B: int, T: int, DI: int) -> int:
    """The forward's segments for a (B, T, DI) call: the most of 1, 4 and 8
    whose blocks (a segment of a (batch, 32-channel block) each) fit two
    an SM, ``2 x SMS``, and no more than T has chunks.  A segment's blocks
    walk their steps twice, so segments pay only where one segment's
    blocks leave SMs idle (PERF.md §6: at hymba's prefill, training and
    train_4k shapes one segment is fastest); two never pay, the second
    waiting for the first's end.  A T = 1 call runs the step kernel,
    unsegmented."""
    blocks = B * -(-DI // FWD_CHANNELS)
    chunks = -(-T // FWD_CHUNK)
    best = 1
    for n in (4, 8):
        if n * blocks <= 2 * SMS and n <= chunks:
            best = n
    return best


def segments(T: int, segment: int) -> int:
    """The segments of a backward call: the smallest power of two that
    covers T steps with ``segment``-step segments (a cluster's blocks)."""
    n = 1
    while n * segment < T:
        n *= 2
    return n


def backward_dynamic_shared_bytes(segment: int) -> int:
    """Dynamic shared bytes of a backward block: a float4 a thread for
    each ``SSM_BWD_CHUNK``-step chunk of its segment."""
    return segment // SSM_BWD_CHUNK * THREADS * 16


def _workspace_shapes(B: int, T: int, DI: int, S: int, segment: int):
    """The float32 workspaces of one backward call: each channel block's
    partial sums of dB and of dC, and each (b, segment, d, s)'s dA
    term."""
    blocks = -(-DI // CHANNELS)
    return ((blocks, B, T, S), (blocks, B, T, S),
            (B, segments(T, segment), DI, S))


def backward_workspace_bytes(B: int, T: int, DI: int, S: int) -> int:
    """Bytes of workspace one backward call allocates."""
    return 4 * sum(math.prod(shape) for shape in
                   _workspace_shapes(B, T, DI, S, segment_length(T)))


def _check(cond: bool, msg: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_inputs(what: str, u, dt, Bm, Cm, A, states, seq=()):
    """The contract both kernels share: float32, contiguous, one CUDA
    device; u, dt and the ``seq`` tensors (B, T, DI), Bm and Cm (B, T, S),
    A (DI, S), ``states`` (B, DI, S), S in :data:`STATE_DIMS`."""
    ts = (u, dt, Bm, Cm, A) + tuple(seq) + tuple(states)
    _check(all(t.is_cuda and t.device == u.device for t in ts),
           "every input must be on one CUDA device", what)
    _check(all(t.dtype == torch.float32 for t in ts),
           "every input must be float32 (the model casts to float32 "
           "first)", what)
    _check(u.dim() == 3 and all(t.shape == u.shape for t in (dt,) + seq),
           "u, dt (and dy) must share one (B, T, DI) shape", what)
    B, T, DI = u.shape
    _check(min(B, T, DI) >= 1, f"empty input {tuple(u.shape)}", what)
    _check(A.dim() == 2 and A.shape[0] == DI, "A must be (DI, S)", what)
    S = A.shape[1]
    _check(S in STATE_DIMS, f"state size {S} not in {STATE_DIMS}", what)
    _check(Bm.shape == (B, T, S) and Cm.shape == (B, T, S),
           "Bm and Cm must be (B, T, S)", what)
    _check(all(t.shape == (B, DI, S) for t in states),
           "the states must be (B, DI, S)", what)
    _check(all(t.is_contiguous() for t in ts),
           "every input must be contiguous", what)
    # int offsets; the forward's run one 16-step chunk past the end
    _check(B <= 65535 and (B * T + 16) * max(DI, S) < 2 ** 31, "too large",
           what)
    return B, T, DI, S


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it that starts on 16 bytes (a contiguous view
    into a larger tensor may not): the kernels read A, the states, and at
    T = 1 B and C, as float4."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor,
                        state: Optional[torch.Tensor] = None,
                        segments: Optional[int] = None):
    """Launch the forward on the current stream; same contract as
    ``kernels.ref.selective_scan_ref``, float32 only.

      u, dt  : (B, T, DI) float32, contiguous
      Bm, Cm : (B, T, S) float32, contiguous, S in :data:`STATE_DIMS`
      A      : (DI, S) float32, contiguous
      state  : None, or the initial state (B, DI, S) float32, contiguous
      segments : T > 1 only: the segments to cut T into, 1 to
               :data:`SEGMENTS` (default :func:`forward_segments`)

    Returns y, a new (B, T, DI) float32 tensor; with a ``state``, ``(y,
    final_state)``, the final state a new tensor."""
    global launches
    B, T, DI, S = _check_inputs("selective_scan_cuda", u, dt, Bm, Cm, A,
                                () if state is None else (state,))
    y = torch.empty_like(u)
    final = None if state is None else torch.empty_like(state)
    A, state = _aligned(A), _aligned(state)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if T == 1 and segments is None:
        Bm, Cm = _aligned(Bm), _aligned(Cm)
        rc = build().repro_selective_scan_step(
            u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), _ptr(state), _ptr(final), y.data_ptr(), B, DI, S,
            stream)
    else:
        nseg = forward_segments(B, T, DI) if segments is None else segments
        _check(1 <= nseg <= SEGMENTS, f"segments={nseg} not in 1.."
               f"{SEGMENTS}", "selective_scan_cuda")
        vec = DI % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (u, dt, Bm, Cm))
        rc = build().repro_selective_scan(
            u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), _ptr(state), _ptr(final), y.data_ptr(), B, T, DI,
            S, forward_segment_length(T, nseg), 1 if vec else 0, stream)
    if rc != 0:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return y if state is None else (y, final)


def selective_scan_bwd_cuda(u: torch.Tensor, dt: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            A: torch.Tensor, state: Optional[torch.Tensor],
                            dy: torch.Tensor,
                            dstate_final: Optional[torch.Tensor] = None):
    """Launch the backward on the current stream; same contract as
    ``kernels.ref.selective_scan_bwd_ref``: the forward's inputs as in
    :func:`selective_scan_cuda` (``state`` None: zero), ``dy`` (B, T, DI)
    and ``dstate_final`` None (zero) or (B, DI, S), float32, contiguous;
    T at most :data:`MAX_BACKWARD_T`, in segments of
    :func:`segment_length`.

    Returns ``(du, ddt, dB, dC, dA, dstate0)``, new float32 tensors;
    ``dstate0`` is None when ``state`` is."""
    global backward_launches
    what = "selective_scan_bwd_cuda"
    states = tuple(t for t in (state, dstate_final) if t is not None)
    B, T, DI, S = _check_inputs(what, u, dt, Bm, Cm, A, states, seq=(dy,))
    _check(-(-DI // CHANNELS) <= 65535, f"DI={DI} too large", what)
    _check(T <= MAX_BACKWARD_T, f"T={T} too long: the backward takes at "
           f"most {MAX_BACKWARD_T} steps ({SEGMENTS} segments of "
           f"{MAX_SEGMENT})", what)
    segment = segment_length(T)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.empty_like(A)
    dstate0 = None if state is None else torch.empty_like(state)
    part_b, part_c, da_part = (
        torch.empty(shape, dtype=torch.float32, device=u.device)
        for shape in _workspace_shapes(B, T, DI, S, segment))
    rc = build().repro_selective_scan_bwd(
        *(_ptr(t) for t in (u, dt, Bm, Cm, A, state, dy, dstate_final, du,
                            ddt, dB, dC, dA, dstate0, part_b, part_c,
                            da_part)),
        B, T, DI, S, segment, torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective scan backward launch failed: CUDA "
                           f"error {rc}")
    backward_launches += 1
    return du, ddt, dB, dC, dA, dstate0
