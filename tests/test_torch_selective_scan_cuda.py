"""The CUDA selective-scan (Mamba) kernels against their plain versions,
on the card: the forward (``selective_scan_cuda``) and training's
backward (``selective_scan_bwd_cuda``, held to ``selective_scan_bwd_ref``),
float32.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_selective_scan_cuda.py

Without a card every test here skips.  Inputs: normal u, B, C and a
carried state; dt the softplus of a normal shifted by -2 (the model's
``dt_bias`` init), or log-uniform over [1e-4, 30] (exp(dt A) from ~1 down
to an exact 0); A = -exp(log(1..16) + 0.1 normal).  Tolerance: 1e-4 of
max |plain| for every output and grad (both keep the state in float32 and
sum over the states, the channels and time in another order).  The
backward walks 16-step chunks in at most 8 segments of at least four
chunks (unless one segment), so T = 1, 15, 16, 17 and 33 cover ragged,
whole and several chunks in one segment, T = 150 two segments of 80, T =
300 four, and T = 1000 at full width eight of 128, each with a ragged
last one; DI = 40 and 3200 a ragged and a whole last block of 16
channels.  The forward stages 16 steps at a time in blocks of 32
channels, in 1 to 8 segments (each count is held at four shapes, two
calls bitwise equal), with no limit on T (32,768); T = 1 runs its step
kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ssk
from repro_torch.kernels.ref import selective_scan_bwd_ref, selective_scan_ref

TOL = 1e-4


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(device, B, T, DI, seed=0, extreme=False, S=16):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, T, DI))
    if extreme:
        dt = np.exp(rng.uniform(np.log(1e-4), np.log(30.0), (B, T, DI)))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, DI)) - 2))
    Bm, Cm = (rng.standard_normal((B, T, S)) for _ in range(2))
    A = -np.exp(np.log(np.arange(1, S + 1))[None]
                + 0.1 * rng.standard_normal((DI, S)))
    h0, dh = (rng.standard_normal((B, DI, S)) for _ in range(2))
    dy = rng.standard_normal((B, T, DI))
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device)
            for a in (u, dt, Bm, Cm, A, h0, dy, dh)]


def _close(got, want, what):
    assert torch.isfinite(got).all(), what
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (what, err)


SHAPES = [(1, 1, 40), (2, 15, 48), (2, 16, 40), (3, 17, 64), (2, 33, 40),
          (2, 150, 40), (1, 300, 48), (4, 1, 3200), (2, 64, 3200),
          (2, 1000, 3200)]


@pytest.mark.gpu
@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("B,T,DI", SHAPES)
def test_forward_matches_plain_version(cuda_device, B, T, DI, carried,
                                       extreme):
    u, dt, Bm, Cm, A, h0, _, _ = _inputs(cuda_device, B, T, DI, seed=T + DI,
                                         extreme=extreme)
    state = h0 if carried else None
    n0 = ssk.launches
    got = ops.selective_scan(u, dt, Bm, Cm, A, state=state)
    torch.cuda.synchronize()
    assert ssk.launches == n0 + 1
    want = selective_scan_ref(u, dt, Bm, Cm, A, state=state)
    if not carried:
        got, want = (got,), (want,)
    for name, g, w in zip(("y", "final state"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("B,T,DI", SHAPES)
def test_backward_matches_plain_version(cuda_device, B, T, DI, carried,
                                        extreme):
    u, dt, Bm, Cm, A, h0, dy, dh = _inputs(cuda_device, B, T, DI,
                                           seed=2 * T + DI, extreme=extreme)
    state, dfinal = (h0, dh) if carried else (None, None)
    n0 = ssk.backward_launches
    got = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, state, dy, dfinal)
    torch.cuda.synchronize()
    assert ssk.backward_launches == n0 + 1
    want = selective_scan_bwd_ref(u, dt, Bm, Cm, A, state, dy, dfinal)
    assert (got[5] is None) == (not carried)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA", "dstate0"), got,
                          want):
        if w is not None:
            _close(g, w, name)


@pytest.mark.gpu
def test_backward_is_the_same_from_run_to_run(cuda_device):
    """No float atomics: two calls on the same inputs give the same bits
    (dB and dC summed over 200 channel blocks, dA over the batch and the
    segments, the state and its adjoint carried across the segments)."""
    u, dt, Bm, Cm, A, h0, dy, dh = _inputs(cuda_device, 2, 256, 3200, seed=5)
    a = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, h0, dy, dh)
    b = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, h0, dy, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4096, ssk.MAX_BACKWARD_T])
def test_backward_takes_long_segments(cuda_device, T):
    """Segments past 384 steps take more than 48 KB of dynamic shared
    memory, which the kernel opts into: hymba's train_4k length (8
    segments of 512) and the longest T (8 of 1,536), from a carried state
    with a final-state grad, held to the plain version and bitwise from
    call to call."""
    u, dt, Bm, Cm, A, h0, dy, dh = _inputs(cuda_device, 1, T, 40, seed=7)
    got = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, h0, dy, dh)
    again = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, h0, dy, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = selective_scan_bwd_ref(u, dt, Bm, Cm, A, h0, dy, dh)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA", "dstate0"), got,
                          want):
        _close(g, w, name)


@pytest.mark.gpu
def test_autograd_route_runs_the_backward_kernel(cuda_device):
    """``ops.selective_scan`` under autograd: one forward launch, one
    backward call, the grads those of the plain reverse recurrence."""
    u, dt, Bm, Cm, A, h0, dy, dh = _inputs(cuda_device, 2, 37, 48, seed=6)
    xs = [t.clone().requires_grad_() for t in (u, dt, Bm, Cm, A, h0)]
    n0 = (ssk.launches, ssk.backward_launches)
    y, h = ops.selective_scan(*xs[:5], state=xs[5])
    grads = torch.autograd.grad([y, h], xs, grad_outputs=[dy, dh])
    torch.cuda.synchronize()
    assert (ssk.launches, ssk.backward_launches) == (n0[0] + 1, n0[1] + 1)
    want = selective_scan_bwd_ref(u, dt, Bm, Cm, A, h0, dy, dh)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA", "dstate0"), grads,
                          want):
        _close(g, w, name)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    u, dt, Bm, Cm, A, h0, dy, _ = _inputs(cuda_device, 1, 4, 40)
    with pytest.raises(ValueError, match="float32"):
        ssk.selective_scan_cuda(u.bfloat16(), dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan_cuda(u, dt, Bm[..., :8].contiguous(),
                                Cm[..., :8].contiguous(),
                                A[:, :8].contiguous())
    strided = u.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssk.selective_scan_cuda(strided, dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="states"):
        ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, h0[:, :8], dy)
    T = ssk.MAX_BACKWARD_T + 1
    u, dt, Bm, Cm, A, _, dy, _ = _inputs(cuda_device, 1, T, 16)
    with pytest.raises(ValueError, match="too long"):
        ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, None, dy)


@pytest.mark.gpu
def test_kernel_attributes_report_no_spill(cuda_device):
    for which, name in enumerate(ssk.KERNELS):
        attrs = ssk.kernel_attributes(which)
        assert attrs["registers"] > 0 and attrs["local_bytes"] == 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,DI", [(2, 150, 40), (1, 300, 48),
                                    (2, 1000, 3200), (2, 64, 3200)])
@pytest.mark.parametrize("nseg", range(1, 9))
def test_forward_in_any_segment_count(cuda_device, B, T, DI, nseg):
    """The forward cut into 1 .. 8 segments (a cluster; the segments' ends
    hopped through distributed shared memory), from a carried state with
    extreme step sizes: y and the final state within TOL, and two calls
    bitwise equal."""
    u, dt, Bm, Cm, A, h0, _, _ = _inputs(cuda_device, B, T, DI, seed=nseg,
                                         extreme=True)
    got = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0, segments=nseg)
    again = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0,
                                    segments=nseg)
    torch.cuda.synchronize()
    want = selective_scan_ref(u, dt, Bm, Cm, A, state=h0)
    for name, g, a, w in zip(("y", "final state"), got, again, want):
        _close(g, w, name)
        assert torch.equal(g, a), name


@pytest.mark.gpu
def test_forward_takes_a_long_sequence(cuda_device):
    """T = 32,768 (no limit on the forward's T): from a carried state,
    within TOL, two calls bitwise equal."""
    u, dt, Bm, Cm, A, h0, _, _ = _inputs(cuda_device, 1, 32768, 64, seed=3)
    got = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0)
    again = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0)
    torch.cuda.synchronize()
    want = selective_scan_ref(u, dt, Bm, Cm, A, state=h0)
    for name, g, a, w in zip(("y", "final state"), got, again, want):
        _close(g, w, name)
        assert torch.equal(g, a), name


@pytest.mark.gpu
@pytest.mark.parametrize("B,DI", [(4, 3200), (3, 40), (1, 7)])
def test_step_kernel_from_a_carried_state(cuda_device, B, DI):
    """T = 1 runs the step kernel (one launch): y and the final state
    within TOL from a carried state; an input off 16 bytes is copied to
    an aligned one first, not refused."""
    u, dt, Bm, Cm, A, h0, _, _ = _inputs(cuda_device, B, 1, DI, seed=DI)
    want = selective_scan_ref(u, dt, Bm, Cm, A, state=h0)
    n0 = ssk.launches
    got = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0)
    off = torch.empty(h0.numel() + 1, device=cuda_device)[1:].view(h0.shape)
    off.copy_(h0)
    shifted = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=off)
    torch.cuda.synchronize()
    assert ssk.launches == n0 + 2
    for name, g, s, w in zip(("y", "final state"), got, shifted, want):
        _close(g, w, name)
        assert torch.equal(g, s), name
