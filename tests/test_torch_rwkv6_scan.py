"""The port's RWKV-6 WKV recurrence (``repro_torch.kernels``) against the
JAX package's Pallas kernel (interpret mode on the CPU), and, from a
carried state, against the model's own ``lax.scan`` form of it.

Inputs are made with numpy from a seed, drawn as ``tests/test_kernels.py``
draws them (normal r/k/v, w = sigmoid(normal), u = 0.1 normal), and in an
extreme-decay draw: w = exp(-exp(x)) with x uniform over [-8, 6], plus
exact 0s and values of 1 - 2**-24.  On the CPU ``ops.rwkv6_scan`` runs
the plain step loop; the CUDA kernel is held to it on the card by
``chip_smoke.py`` and by ``tests/test_torch_rwkv6_scan_cuda.py``.  The
plain model of the kernel's algorithm, ``ref.rwkv6_scan_chunked_ref``
(chunks, key-channel tiles, running products of the decays), is held here to
the step loop, to the Pallas kernel and to the model's scan, with chunk
lengths that leave a ragged last chunk, a single step and whole chunks.
The backward's reverse recurrence (``ref.rwkv6_scan_bwd_ref``, the CPU
path of the autograd Function) and the plain model of the CUDA backward's
arithmetic (``ref.rwkv6_scan_bwd_chunked_ref``: the chunk walks and the
per-chunk forms) are held to ``jax.vjp`` of the model's scan, to autograd
of the step loop and to each other.

Tolerances, the ``tests/test_kernels.py`` bounds: 1e-4 in f32 (both sides
keep the state in f32 and sum in another order), 3e-2 / 3e-1 (rtol /
atol) with bf16 inputs and outputs.
"""

import math
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as wkv


def _inputs(seed, B, T, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, hd))))
         ).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _extreme_decays(seed, B, T, H, hd):
    """w = exp(-exp(x)), x uniform over [-8, 6]: from ~0.9997 down to an
    underflow to 0; every 7th value exactly 0, every 11th 1 - 2**-24."""
    rng = np.random.default_rng(seed)
    w = np.exp(-np.exp(rng.uniform(-8.0, 6.0, (B, T, H, hd))))
    w = w.astype(np.float32)
    w.flat[::7] = 0.0
    w.flat[3::11] = np.float32(1.0 - 2.0 ** -24)
    return w


def _jax_scan_from(r, k, v, w, u, s0, as_numpy=True):
    """The model's recurrence (``repro/models/ssm.py`` ``_rwkv_time_mix``'s
    step) as a ``lax.scan`` from ``s0``: (y, final state)."""
    u = jnp.asarray(u)

    def step(S, inp):
        r_t, k_t, v_t, w_t = inp
        kv = jnp.einsum("bhk,bhv->bhkv", k_t, v_t)
        y = jnp.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
        return w_t[..., None] * S + kv, y

    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, w))
    S, ys = jax.lax.scan(step, jnp.asarray(s0), xs)
    y = jnp.moveaxis(ys, 0, 1)
    return (np.asarray(y), np.asarray(S)) if as_numpy else (y, S)


@pytest.mark.parametrize("B,T,H,hd,chunk", [(1, 32, 2, 8, 8),
                                            (2, 64, 2, 16, 16)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_matches_pallas_from_zero(B, T, H, hd, chunk, bf16):
    r, k, v, w, u, _ = _inputs(T + hd, B, T, H, hd)
    xs = [r, k, v, w]
    if bf16:
        xs = [a.astype(ml_dtypes.bfloat16) for a in xs]
    want = np.asarray(jops.rwkv6_scan(*(jnp.asarray(a) for a in xs),
                                      jnp.asarray(u), chunk=chunk,
                                      interpret=True)).astype(np.float32)
    ts = [torch.from_numpy(a.astype(np.float32)) for a in xs]
    if bf16:
        ts = [t.to(torch.bfloat16) for t in ts]
    got = ops.rwkv6_scan(*ts, torch.from_numpy(u))
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = (dict(rtol=3e-2, atol=3e-1) if bf16
           else dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("B,T,H,hd", [(2, 24, 2, 16), (1, 1, 3, 32),
                                      (2, 37, 2, 8)])
def test_carried_state_matches_the_model_scan(B, T, H, hd):
    r, k, v, w, u, s0 = _inputs(T, B, T, H, hd)
    want_y, want_s = _jax_scan_from(r, k, v, w, u, s0)
    y, s = ops.rwkv6_scan(*map(torch.from_numpy, (r, k, v, w, u)),
                          state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4, atol=1e-4)


def test_zero_state_is_the_kernel_function():
    """With a zero initial state the carried form gives the kernel's y."""
    r, k, v, w, u, s0 = _inputs(5, 2, 16, 2, 8)
    ts = list(map(torch.from_numpy, (r, k, v, w, u)))
    y0 = ops.rwkv6_scan(*ts)
    y, _ = ops.rwkv6_scan(*ts, state=torch.zeros_like(torch.from_numpy(s0)))
    assert torch.equal(y, y0)


def test_cpu_route_never_builds_the_kernel(monkeypatch):
    monkeypatch.setattr(wkv, "build", lambda: pytest.fail("built"))
    n0 = wkv.launches
    r, k, v, w, u, s0 = _inputs(1, 1, 4, 2, 8)
    ops.rwkv6_scan(*map(torch.from_numpy, (r, k, v, w, u)),
                   state=torch.from_numpy(s0))
    assert wkv.launches == n0 and wkv._lib is None


# (chunk, keys) of the plain model of the kernel: its default, one key
# tile a head, chunks longer than most sequences here with narrow tiles
CHUNKINGS = [(16, 32), (32, 64), (64, 16)]


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("chunk,keys", CHUNKINGS)
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64, 300])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
def test_chunked_model_matches_the_step_loop(T, hd, chunk, keys, carried):
    r, k, v, w, u, s0 = _inputs(T + hd + chunk, 2, T, 2, hd)
    ts = _torch(r, k, v, w, u)
    state = torch.from_numpy(s0) if carried else None
    got = ref.rwkv6_scan_chunked_ref(*ts, state=state, chunk=chunk, keys=keys)
    want = ref.rwkv6_scan_ref(*ts, state=state)
    if not carried:
        got, want = (got,), (want,)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("chunk,keys", CHUNKINGS)
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64, 300])
def test_chunked_model_matches_pallas(T, hd, chunk, keys):
    r, k, v, w, u, _ = _inputs(2 * T + hd, 1, T, 2, hd)
    want = np.asarray(jops.rwkv6_scan(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=math.gcd(T, 16),
        interpret=True))
    got = ref.rwkv6_scan_chunked_ref(*_torch(r, k, v, w, u), chunk=chunk,
                                     keys=keys)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk,keys", CHUNKINGS)
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 17, 300])
def test_chunked_model_matches_the_model_scan(T, hd, chunk, keys):
    r, k, v, w, u, s0 = _inputs(3 * T + hd, 2, T, 2, hd)
    want_y, want_s = _jax_scan_from(r, k, v, w, u, s0)
    y, s = ref.rwkv6_scan_chunked_ref(*_torch(r, k, v, w, u),
                                      state=torch.from_numpy(s0),
                                      chunk=chunk, keys=keys)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk,keys", CHUNKINGS)
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64, 300])
def test_chunked_model_extreme_decays(T, hd, chunk, keys):
    """Decays that underflow to 0, exact 0s and 1 - 2**-24: every factor
    is a running product, so y and the state stay finite and equal the
    step loop's."""
    r, k, v, _, u, s0 = _inputs(T + 5, 2, T, 2, hd)
    w = _extreme_decays(T + 6, 2, T, 2, hd)
    assert w.min() == 0.0 and w.max() == np.float32(1.0 - 2.0 ** -24)
    ts = _torch(r, k, v, w, u)
    y, s = ref.rwkv6_scan_chunked_ref(*ts, state=torch.from_numpy(s0),
                                      chunk=chunk, keys=keys)
    want_y, want_s = ref.rwkv6_scan_ref(*ts, state=torch.from_numpy(s0))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_chunked_model_bf16_inputs():
    """bf16 r/k/v/w give y in bf16, within the bf16 bound of the step
    loop on the same inputs."""
    r, k, v, w, u, s0 = _inputs(11, 2, 37, 2, 32)
    ts = [t.to(torch.bfloat16) for t in _torch(r, k, v, w)]
    y, s = ref.rwkv6_scan_chunked_ref(*ts, torch.from_numpy(u),
                                      state=torch.from_numpy(s0))
    want_y, want_s = ref.rwkv6_scan_ref(*ts, torch.from_numpy(u),
                                        state=torch.from_numpy(s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               rtol=3e-2, atol=3e-1)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the backward: the plain reverse recurrence, and ops.rwkv6_scan's autograd
# ---------------------------------------------------------------------------


def _jax_vjp_from(r, k, v, w, u, s0, dy, ds):
    """jax.vjp of the model's scan (``_jax_scan_from``) at the cotangents
    (dy, ds): the grads of r, k, v, w, u and s0."""
    _, vjp = jax.vjp(lambda *xs: _jax_scan_from(*xs, as_numpy=False),
                     *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]


def _cotangents(seed, B, T, H, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, H, hd, hd)).astype(np.float32))


BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


@pytest.mark.parametrize("B,T,H,hd", [(2, 1, 2, 32), (1, 15, 2, 8),
                                      (2, 16, 2, 32), (2, 17, 3, 16),
                                      (1, 37, 2, 32)])
@pytest.mark.parametrize("extreme", [False, True], ids=["decays", "extreme"])
def test_bwd_ref_matches_jax_grad_of_the_model_scan(B, T, H, hd, extreme):
    """Every grad, from a carried state with a final-state grad, T ragged
    against the 16-step chunk or not; extreme decays (exact 0s) included,
    every value finite."""
    r, k, v, w, u, s0 = _inputs(3 * T + hd, B, T, H, hd)
    if extreme:
        w = _extreme_decays(T + 1, B, T, H, hd)
    dy, ds = _cotangents(T, B, T, H, hd)
    want = _jax_vjp_from(r, k, v, w, u, s0, dy, ds)
    got = ref.rwkv6_scan_bwd_ref(*_torch(r, k, v, w, u, s0, dy, ds))
    for name, g, w_ in zip(BWD_NAMES, got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("T", [1, 16, 23, 32, 47])
def test_bwd_ref_matches_autograd_of_the_step_loop(T, carried):
    """From zero with no final-state grad (the training case), and from a
    carried state with one; T within one kept chunk, on its boundaries
    and ragged across several."""
    r, k, v, w, u, s0 = _inputs(T + 40, 2, T, 3, 8)
    dy, ds = _cotangents(T + 41, 2, T, 3, 8)
    xs = [t.requires_grad_() for t in _torch(r, k, v, w, u, s0)]
    out = ref.rwkv6_scan_ref(*xs[:5], state=xs[5] if carried else None)
    if carried:
        loss = (out[0] * torch.from_numpy(dy)).sum() + \
            (out[1] * torch.from_numpy(ds)).sum()
    else:
        loss = (out * torch.from_numpy(dy)).sum()
    # (from zero, w of the last step reaches nothing: its grad is 0)
    want = torch.autograd.grad(loss, xs if carried else xs[:5],
                               materialize_grads=True)
    got = ref.rwkv6_scan_bwd_ref(
        *_torch(r, k, v, w, u), torch.from_numpy(s0) if carried else None,
        torch.from_numpy(dy), torch.from_numpy(ds) if carried else None)
    for name, g, w_ in zip(BWD_NAMES, got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4, msg=name)


def test_bwd_ref_padded_steps_add_nothing():
    """Steps with r = k = v = dy = 0 and w = 1 appended to a sequence
    leave every grad of the real steps as it was, and get zero grads
    but dw (G S, which the real steps' states make)."""
    r, k, v, w, u, s0 = _inputs(12, 2, 13, 2, 8)
    dy, ds = _cotangents(13, 2, 13, 2, 8)

    def pad(x, value):
        return np.concatenate([x, np.full((2, 3, 2, 8), value, np.float32)], 1)

    got = ref.rwkv6_scan_bwd_ref(*_torch(pad(r, 0), pad(k, 0), pad(v, 0),
                                         pad(w, 1), u, s0, pad(dy, 0), ds))
    want = ref.rwkv6_scan_bwd_ref(*_torch(r, k, v, w, u, s0, dy, ds))
    for name, g, w_ in zip(BWD_NAMES, got, want):
        if g.dim() == 4 and name != "dstate0":
            if name != "dw":
                assert torch.equal(g[:, 13:], torch.zeros_like(g[:, 13:]))
            g = g[:, :13]
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
def test_ops_autograd_on_the_cpu_is_the_plain_backward(carried, monkeypatch):
    """``ops.rwkv6_scan`` differentiates through ``rwkv6_scan_bwd_ref`` on
    CPU tensors and never builds the kernel; the final state's grad may be
    absent (training drops the final state)."""
    monkeypatch.setattr(wkv, "build", lambda: pytest.fail("built"))
    n0, b0 = wkv.launches, wkv.backward_launches
    r, k, v, w, u, s0 = _inputs(4, 2, 21, 2, 8)
    dy, _ = _cotangents(5, 2, 21, 2, 8)
    xs = [t.requires_grad_() for t in _torch(r, k, v, w, u, s0)]
    out = ops.rwkv6_scan(*xs[:5], state=xs[5] if carried else None)
    y = out[0] if carried else out
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                              xs if carried else xs[:5])
    want = ref.rwkv6_scan_bwd_ref(*_torch(r, k, v, w, u),
                                  torch.from_numpy(s0) if carried else None,
                                  torch.from_numpy(dy))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert (wkv.launches, wkv.backward_launches) == (n0, b0)
    assert wkv._lib is None


def test_ops_without_grad_records_nothing():
    """Under ``no_grad``, or with no input that needs a grad, the call is
    the forward alone (the serving paths), bf16 inputs included."""
    r, k, v, w, u, s0 = _inputs(6, 1, 8, 2, 8)
    xs = [t.requires_grad_() for t in _torch(r, k, v, w, u)]
    with torch.no_grad():
        y = ops.rwkv6_scan(*xs)
    assert y.grad_fn is None and not y.requires_grad
    y = ops.rwkv6_scan(*(t.detach().to(torch.bfloat16) for t in xs[:4]),
                       xs[4].detach())
    assert y.dtype == torch.bfloat16 and y.grad_fn is None


def test_ops_refuses_a_bf16_input_that_needs_a_grad():
    r, k, v, w, u, _ = _inputs(7, 1, 8, 2, 8)
    xs = [t.to(torch.bfloat16).requires_grad_() for t in _torch(r, k, v, w)]
    with pytest.raises(ValueError, match="float32"):
        ops.rwkv6_scan(*xs, torch.from_numpy(u))


def test_backward_constants_are_the_sources():
    """``ref.WKV_BWD_CHUNK`` sets the chunks of the plain models and sizes
    the wrapper's workspaces: it must be the source's ``bwd::kC``; the
    wrapper's ``BACKWARD_KERNELS`` are the source's backward kernels, in
    launch order.  At rwkv6-3b's training shape (B=2, T=256, 40 heads of
    64) the chunks' S_in and G_out take 40 MiB, beside each chunk's du."""
    src = wkv.SOURCE.read_text()
    body = src[src.index("namespace bwd {"):src.index("}  // namespace bwd")]
    assert int(re.search(r"constexpr int kC = (\d+);", body).group(1)) \
        == ref.WKV_BWD_CHUNK
    launch = body[body.index("int launch_bwd("):]
    at = [launch.index(name + "<") for name in wkv.BACKWARD_KERNELS]
    assert at == sorted(at)
    for name in wkv.BACKWARD_KERNELS:
        assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\)?\s*"
                         + name + r"\(", body), name
    chunks = 256 // ref.WKV_BWD_CHUNK
    states = 2 * 2 * 40 * chunks * 64 * 64 * 4
    assert states == 40 * 2 ** 20
    assert wkv.backward_workspace_bytes(2, 256, 40, 64) == (
        states + 4 * 2 * 40 * chunks * 64)


# ---------------------------------------------------------------------------
# the plain model of the backward kernel's arithmetic
# ---------------------------------------------------------------------------

# the plain model against the reverse recurrence and jax.vjp: 1e-4 (rtol
# and atol), the f32 bound of the backward (both sides sum the f32 state's
# products in another order; measured <= 7e-7 of max |grad| here)
CHUNKED_T = [1, 15, 16, 17, 300]


def _bwd_case(T, hd, carried, extreme):
    r, k, v, w, u, s0 = _inputs(T + 2 * hd, 2, T, 2, hd)
    if extreme:
        w = _extreme_decays(T + 3, 2, T, 2, hd)
        assert w.min() == 0.0
    dy, ds = _cotangents(T + 4, 2, T, 2, hd)
    if not carried:
        s0, ds = np.zeros_like(s0), np.zeros_like(ds)
    return r, k, v, w, u, s0, dy, ds


@pytest.mark.parametrize("extreme", [False, True], ids=["decays", "extreme"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", CHUNKED_T)
def test_bwd_chunked_model_matches_the_reverse_recurrence(T, hd, carried,
                                                          extreme):
    """From zero with no final-state grad (training) and from a carried
    state with one; T ragged against the 16-step chunk, whole, one step
    past, and 19 chunks; extreme decays (exact 0s, 1 - 2**-24) give finite
    grads equal to the recurrence's."""
    r, k, v, w, u, s0, dy, ds = _bwd_case(T, hd, carried, extreme)
    xs = _torch(r, k, v, w, u)
    state, dfinal = ((torch.from_numpy(s0), torch.from_numpy(ds)) if carried
                     else (None, None))
    got = ref.rwkv6_scan_bwd_chunked_ref(*xs, state, torch.from_numpy(dy),
                                         dfinal)
    want = ref.rwkv6_scan_bwd_ref(*xs, state, torch.from_numpy(dy), dfinal)
    for name, g, w_ in zip(BWD_NAMES, got, want):
        if w_ is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("extreme", [False, True], ids=["decays", "extreme"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", CHUNKED_T)
def test_bwd_chunked_model_matches_jax_grad_of_the_model_scan(T, hd, carried,
                                                              extreme):
    """Every grad against ``jax.vjp`` of the model's scan; "zero" is the
    training case (a zero initial state and no final-state grad, whose
    dstate0 is then the scan's grad of its zero start)."""
    r, k, v, w, u, s0, dy, ds = _bwd_case(T, hd, carried, extreme)
    want = _jax_vjp_from(r, k, v, w, u, s0, dy, ds)
    got = ref.rwkv6_scan_bwd_chunked_ref(*_torch(r, k, v, w, u, s0, dy, ds))
    for name, g, w_ in zip(BWD_NAMES, got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_backward_source_has_no_atomics_and_no_logarithms():
    """The backward's grads are the same bits from run to run (no atomics:
    every sum in a fixed order) and exact where a decay underflows to 0
    (no logarithm: every decay factor is a running product of w).  The
    code of namespace ``bwd``, comments stripped, names neither."""
    src = wkv.SOURCE.read_text()
    body = src[src.index("namespace bwd {"):src.index("}  // namespace bwd")]
    code = re.sub(r"//[^\n]*", "", body)
    assert not re.search(r"atomic|\blogf?\b|__logf|log2|log1p", code)
