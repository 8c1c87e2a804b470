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

Tolerances, the ``tests/test_kernels.py`` bounds: 1e-4 in f32 (both sides
keep the state in f32 and sum in another order), 3e-2 / 3e-1 (rtol /
atol) with bf16 inputs and outputs.
"""

import math

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


def _jax_scan_from(r, k, v, w, u, s0):
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
    return np.asarray(jnp.moveaxis(ys, 0, 1)), np.asarray(S)


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
