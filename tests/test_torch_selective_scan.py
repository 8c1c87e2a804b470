"""The selective-scan (Mamba) recurrence of the port against the JAX
package, on the CPU: the plain forward (``kernels.ref.selective_scan_ref``)
inside the port's ``_mamba_core`` against JAX's ``_mamba_core`` scan, the
plain reverse recurrence (``selective_scan_bwd_ref``) and the
``ops.selective_scan`` autograd route against ``jax.vjp`` through
``_mamba_core`` and against autodiff of the plain forward, the model of
the CUDA backward's segments (``selective_scan_bwd_segmented_ref``)
against the reverse recurrence and ``jax.vjp``, extreme step sizes, and
the routes' contracts.  The CUDA kernels themselves are held to
these plain versions on the card (``test_torch_selective_scan_cuda.py``,
``chip_smoke.py`` phase 13).

Tolerances, each with its reason: the forward within 1e-5 (float32, the
projections and the state sums in another order in each framework); the
grads within 1e-4 (float32 sums over time and channels in another order,
through the same projections); the segmented model within 1e-5 of the
reverse recurrence (the same float32 steps, the state and the adjoint
carried across segments by a product in another association).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import ssm as JSSM
from repro_torch.configs import get_arch
from repro_torch.core import population as pop
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import ssm as TSSM
from repro_torch.train.interop import params_from_numpy

ARCH = "hymba-1.5b"
# a narrow config: d_model 64 (dt_rank 4), d_inner 128, 16 states
NARROW = dict(d_model=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    kw = {**NARROW, **kw}
    return jax_arch(ARCH).reduced(**kw), get_arch(ARCH).reduced(**kw)


def _core_inputs(jcfg, seed, B, T):
    """JAX's mamba params (D and A_log moved off their init, which would
    hide them), post-conv activations u and a carried state h0."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        np.asarray, JSSM.mamba_init(jax.random.key(seed), jcfg))
    DI, S = jcfg.d_inner, jcfg.ssm_state
    p["A_log"] = (p["A_log"] + 0.1 * rng.standard_normal((DI, S))
                  ).astype(np.float32)
    p["D"] = (1 + 0.2 * rng.standard_normal(DI)).astype(np.float32)
    p["dt_bias"] = (p["dt_bias"] + 0.5 * rng.standard_normal(DI)
                    ).astype(np.float32)
    u = rng.standard_normal((B, T, DI)).astype(np.float32)
    h0 = rng.standard_normal((B, DI, S)).astype(np.float32)
    return p, u, h0


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


@pytest.mark.parametrize("T", [1, 7, 33], ids=["decode", "short", "long"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_plain_forward_matches_jax_mamba_core(T, carried):
    jcfg, tcfg = _configs()
    p, u, h0 = _core_inputs(jcfg, T, 2, T)
    if not carried:
        h0 = np.zeros_like(h0)
    jy, jh = JSSM._mamba_core(_jtree(p), jcfg, jnp.asarray(u),
                              jnp.asarray(h0))
    ty, th = TSSM._mamba_core(params_from_numpy(p, "cpu"), tcfg,
                              torch.from_numpy(u), torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_forward_from_no_state_equals_the_zero_state():
    """``state`` None (training) computes what a zero state computes, and
    returns no final state."""
    jcfg, tcfg = _configs()
    p, u, _ = _core_inputs(jcfg, 3, 2, 9)
    tp, tu = params_from_numpy(p, "cpu"), torch.from_numpy(u)
    y0, h = TSSM._mamba_core(tp, tcfg, tu, None)
    y1, _ = TSSM._mamba_core(tp, tcfg, tu, torch.zeros(2, tcfg.d_inner, 16))
    assert h is None and torch.equal(y0, y1)


def _assert_core_grads_match_jax_vjp(T):
    """The vjp of ``_mamba_core`` from a carried state, with cotangents on
    y and on the final state, against the port's autograd route."""
    jcfg, tcfg = _configs()
    p, u, h0 = _core_inputs(jcfg, 10 + T, 2, T)
    rng = np.random.default_rng(T)
    dy = rng.standard_normal(u.shape).astype(np.float32)
    dh = rng.standard_normal(h0.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda pp, uu, hh: JSSM._mamba_core(pp, jcfg, uu, hh),
                     _jtree(p), jnp.asarray(u), jnp.asarray(h0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    args = [params_from_numpy(p, "cpu"), torch.from_numpy(u),
            torch.from_numpy(h0)]
    leaves = [t.requires_grad_() for t in pop.tree_leaves(args)]
    ty, th = TSSM._mamba_core(args[0], tcfg, args[1], args[2])
    got = torch.autograd.grad([ty, th], leaves,
                              grad_outputs=[torch.from_numpy(dy),
                                            torch.from_numpy(dh)],
                              allow_unused=True)  # the conv and projections
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, got)]
    paths = [path for path, _ in pop.tree_paths(args)]
    for path, g, w in zip(paths, got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    grads = dict(zip(paths, got))
    for leaf in ("A_log", "x_proj", "dt_proj", "dt_bias"):
        assert grads[(0, leaf)].abs().max() > 0, leaf


@pytest.mark.parametrize("T", [1, 16, 37], ids=["one", "chunk", "ragged"])
def test_core_grads_match_jax_vjp(T):
    """The vjp of ``_mamba_core`` from a carried state, with cotangents on
    y and on the final state: the grads of every mamba param (dt's reach
    ``dt_proj`` / ``dt_bias``, B's and C's ``x_proj``, ``A_log`` directly),
    of u and of the carried state, through ``ops.selective_scan``'s
    backward (the plain reverse recurrence on the CPU), where JAX
    differentiates its scan."""
    _assert_core_grads_match_jax_vjp(T)


def test_segmented_grads_match_jax_vjp(monkeypatch):
    """The same vjp with the route's CPU backward replaced by the model of
    the CUDA backward: 37 steps in three 16-step segments, the last
    ragged."""
    monkeypatch.setattr(ops, "selective_scan_bwd_ref", functools.partial(
        ref.selective_scan_bwd_segmented_ref, segment=16))
    _assert_core_grads_match_jax_vjp(37)


def _scan_inputs(seed, B, T, DI, S=16, extreme=False):
    """float32 u, dt (softplus of a normal, or ``extreme``: log-uniform
    over [1e-4, 30], so exp(dt A) spans 1 down to an exact 0), B, C, the
    reference's A at its init (-1 .. -16) moved a little, a carried state
    and the upstream grads."""
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
    return [torch.from_numpy(np.asarray(a, np.float32))
            for a in (u, dt, Bm, Cm, A, h0, dy, dh)]


@pytest.mark.parametrize("T", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme"])
def test_bwd_ref_matches_autodiff_of_the_plain_forward(T, carried, extreme):
    """The reverse recurrence (chunk boundaries kept, each chunk's states
    recomputed) against torch's autodiff of the step loop: every grad
    within 1e-4 of max |autodiff|, and finite with extreme step sizes."""
    u, dt, Bm, Cm, A, h0, dy, dh = _scan_inputs(T, 2, T, 24,
                                                extreme=extreme)
    state, dfinal = (h0, dh) if carried else (None, None)
    got = ref.selective_scan_bwd_ref(u, dt, Bm, Cm, A, state, dy, dfinal)
    xs = [t.clone().requires_grad_() for t in (u, dt, Bm, Cm, A)]
    st = None if state is None else state.clone().requires_grad_()
    out = ref.selective_scan_ref(*xs, state=st)
    outs, cots = ((out,), (dy,)) if st is None else (out, (dy, dfinal))
    want = torch.autograd.grad(outs, xs + ([] if st is None else [st]),
                               grad_outputs=cots)
    assert (got[5] is None) == (not carried)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA", "dstate0"), got,
                          want):
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


@pytest.mark.parametrize("T", [1, 15, 16, 17, 40, 100])
@pytest.mark.parametrize("segment", [16, 32])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme"])
def test_segmented_bwd_ref_matches_the_reverse_recurrence(T, segment, carried,
                                                          extreme):
    """The model of the CUDA backward (segments walked at once, joined by
    the two hops) against the reverse recurrence: one segment, several,
    and a ragged last one; every grad within 1e-5 of max |plain|."""
    u, dt, Bm, Cm, A, h0, dy, dh = _scan_inputs(T, 2, T, 24,
                                                extreme=extreme)
    state, dfinal = (h0, dh) if carried else (None, None)
    want = ref.selective_scan_bwd_ref(u, dt, Bm, Cm, A, state, dy, dfinal)
    got = ref.selective_scan_bwd_segmented_ref(u, dt, Bm, Cm, A, state, dy,
                                               dfinal, segment=segment)
    assert (got[5] is None) == (not carried)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA", "dstate0"), got,
                          want):
        if w is None:
            continue
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


@pytest.mark.parametrize("T", [1, 15, 16, 17, 150, 1000])
@pytest.mark.parametrize("nseg", range(1, 9))
@pytest.mark.parametrize("variant", ["zero-normal", "carried-extreme"])
def test_segmented_forward_matches_the_plain_scan(T, nseg, variant):
    """The model of the CUDA forward (segments walked at once, joined by
    the hop, walked again) against the step-by-step scan: y and the final
    state within 1e-4 of max |plain| and finite, from zero or a carried
    state; with extreme step sizes exp(dt A) reaches an exact 0."""
    extreme = variant == "carried-extreme"
    u, dt, Bm, Cm, A, h0, _, _ = _scan_inputs(T + nseg, 2, T, 24,
                                              extreme=extreme)
    state = h0 if variant.startswith("carried") else None
    L = ssk.forward_segment_length(T, nseg)
    assert L % ssk.FWD_CHUNK == 0 and -(-T // L) <= nseg
    got = ref.selective_scan_segmented_ref(u, dt, Bm, Cm, A, state,
                                           segment=L)
    want = ref.selective_scan_ref(u, dt, Bm, Cm, A, state=state)
    if state is None:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    if extreme and T > 1:
        assert float(torch.exp(dt[..., None] * A).min()) == 0.0


@pytest.mark.parametrize("T,nseg", [(7, 1), (33, 3), (64, 4)])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_segmented_forward_matches_jax_mamba_core(T, nseg, carried,
                                                  monkeypatch):
    """The port's ``_mamba_core`` with the route's CPU forward replaced by
    the model of the CUDA forward, against JAX's ``_mamba_core`` scan
    (within 1e-4)."""
    monkeypatch.setattr(ops, "selective_scan_ref", functools.partial(
        ref.selective_scan_segmented_ref,
        segment=ssk.forward_segment_length(T, nseg)))
    jcfg, tcfg = _configs()
    p, u, h0 = _core_inputs(jcfg, 40 + T, 2, T)
    if not carried:
        h0 = np.zeros_like(h0)
    jy, jh = JSSM._mamba_core(_jtree(p), jcfg, jnp.asarray(u),
                              jnp.asarray(h0))
    ty, th = TSSM._mamba_core(params_from_numpy(p, "cpu"), tcfg,
                              torch.from_numpy(u), torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,T,DI,want", [
    (4, 2048, 3200, 1),      # hymba's prefill: 400 blocks fill the card
    (2, 256, 3200, 1),       # hymba's training shape: 200 blocks
    (1, 4096, 3200, 1),      # train_4k: 100 blocks, 4 x 100 past two an SM
    (1, 4096, 128, 8),       # 4 blocks: 8 segments each
    (1, 2048, 1024, 8),      # 32 blocks: 256 segment blocks, under 264
    (2, 16, 40, 1),          # one chunk: one segment
    (2, 96, 40, 1),          # three chunks of 32: fewer than four
    (2, 128, 40, 4),         # four chunks of 32: four segments
    (2, 1000, 40, 8)])
def test_forward_segments_fill_the_card_and_no_more(B, T, DI, want):
    n = ssk.forward_segments(B, T, DI)
    assert n == want and n in (1, 4, 8)
    blocks = B * -(-DI // ssk.FWD_CHANNELS)
    assert n == 1 or n * blocks <= 2 * ssk.SMS
    L = ssk.forward_segment_length(T, n)
    used = -(-T // L)
    assert L % ssk.FWD_CHUNK == 0 and (used - 1) * L < T <= used * L
    assert used <= n


def test_extreme_step_sizes_stay_finite_through_the_route():
    """dt from 1e-4 to 30 (exp(dt A) down to an exact 0 at A = -16): y,
    the final state and every grad through ``ops.selective_scan`` stay
    finite."""
    u, dt, Bm, Cm, A, h0, dy, dh = _scan_inputs(5, 2, 40, 32, extreme=True)
    assert float(torch.exp(dt[..., None] * A).min()) == 0.0
    xs = [t.requires_grad_() for t in (u, dt, Bm, Cm, A, h0)]
    y, h = ops.selective_scan(*xs[:5], state=xs[5])
    grads = torch.autograd.grad([y, h], xs, grad_outputs=[dy, dh])
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert all(torch.isfinite(g).all() for g in grads)


def test_route_without_grad_is_the_forward_alone():
    u, dt, Bm, Cm, A, h0, _, _ = _scan_inputs(6, 2, 9, 16)
    y, h = ops.selective_scan(u, dt, Bm, Cm, A, state=h0)
    want = ref.selective_scan_ref(u, dt, Bm, Cm, A, state=h0)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert not y.requires_grad


@pytest.mark.parametrize("which", ["u", "state"])
def test_a_bf16_input_that_needs_a_grad_raises(which):
    u, dt, Bm, Cm, A, h0, _, _ = _scan_inputs(7, 1, 4, 16)
    if which == "u":
        u = u.bfloat16().requires_grad_()
    else:
        h0 = h0.bfloat16().requires_grad_()
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan(u, dt, Bm, Cm, A, state=h0)


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the CUDA kernel")

    for name in ("build", "selective_scan_cuda", "selective_scan_bwd_cuda"):
        monkeypatch.setattr(ssk, name, refuse)
    launches = (ssk.launches, ssk.backward_launches)
    u, dt, Bm, Cm, A, h0, dy, dh = _scan_inputs(8, 2, 5, 16)
    xs = [t.requires_grad_() for t in (u, dt, Bm, Cm, A, h0)]
    y, h = ops.selective_scan(*xs[:5], state=xs[5])
    torch.autograd.grad([y, h], xs, grad_outputs=[dy, dh])
    assert (ssk.launches, ssk.backward_launches) == launches
    assert ssk._lib is None


@pytest.mark.parametrize("fn", ["selective_scan_cuda",
                                "selective_scan_bwd_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors_before_building(fn, monkeypatch):
    monkeypatch.setattr(ssk, "build", lambda: pytest.fail("built"))
    u, dt, Bm, Cm, A, h0, dy, _ = _scan_inputs(9, 1, 3, 16)
    args = ((u, dt, Bm, Cm, A) if fn == "selective_scan_cuda"
            else (u, dt, Bm, Cm, A, None, dy))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ssk, fn)(*args)


SOURCE = Path(ssk.SOURCE).read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_constants_are_the_sources():
    """The wrapper's state sizes, channels and threads a backward block,
    its segments at most and the plain backward's chunk are the source's;
    the kernel names are its kernels in launch order; the backward's
    segments and workspaces at the training shape."""
    assert ssk.STATE_DIMS == (_constant("kS"),)
    assert ssk.CHANNELS == _constant("kCh")
    assert ssk.THREADS == _constant("kCh") * _constant("kLanes")
    assert ssk.SEGMENTS == _constant("kSegs")
    assert ssk.MAX_SEGMENT == _constant("kMaxSegment")
    assert ref.SSM_BWD_CHUNK == _constant("kBwdChunk")
    for name in ssk.KERNELS:
        assert re.search(rf"__global__ void __launch_bounds__\([\w, ]+\)"
                         rf"\s*{name}\(", SOURCE), name
    assert ssk.segment_length(256) == 64 and ssk.segments(256, 64) == 4
    # partials 2 x (200, 2, 256, 16), dA (2, 4 segments, 3200, 16)
    assert ssk.backward_workspace_bytes(2, 256, 3200, 16) == 4 * (
        2 * 200 * 2 * 256 * 16 + 2 * 4 * 3200 * 16)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 40, 100, 256, 300, 528, 1000,
                               2048, 4096, ssk.MAX_BACKWARD_T])
def test_segments_cover_the_sequence(T):
    """A power of two of segments, at most ``SEGMENTS``, each a whole
    number of chunks, at least ``MIN_CHUNKS`` of them unless there is one
    segment, and as many as that allows; the first half of them short of
    T and all of them not; the dynamic shared memory a chunk's float4 a
    thread."""
    L = ssk.segment_length(T)
    n = ssk.segments(T, L)
    chunks, C = -(-T // ref.SSM_BWD_CHUNK), ref.SSM_BWD_CHUNK
    assert L % C == 0 and L <= ssk.MAX_SEGMENT
    assert n & (n - 1) == 0 and n <= ssk.SEGMENTS
    assert n == 1 or L >= ssk.MIN_CHUNKS * C
    assert n == ssk.SEGMENTS or chunks < 2 * n * ssk.MIN_CHUNKS
    assert n // 2 * L < T <= n * L
    assert ssk.backward_dynamic_shared_bytes(L) == L // 16 * 128 * 16


def test_forward_constants_are_the_sources():
    """The forward's channels a block and steps a stage are the source's;
    its T = 1 kernel has its own launch bounds."""
    assert ssk.FWD_CHANNELS == _constant("kFwdCh")
    assert ssk.FWD_CHUNK == _constant("kFwdChunk")
    assert ssk.BACKWARD_KERNELS == ("selective_scan_bwd_kernel",
                                    "selective_scan_bwd_reduce_kernel")
    assert "selective_scan_step_kernel" in ssk.KERNELS


def test_source_adds_no_float_atomics():
    """Two backward calls on the same inputs must give the same bits: no
    atomic adds anywhere in the source (comments stripped)."""
    code = re.sub(r"//[^\n]*", "", SOURCE)
    assert "atomic" not in code
