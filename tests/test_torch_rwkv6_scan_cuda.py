"""The CUDA RWKV-6 WKV kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_rwkv6_scan_cuda.py

Without a card every test here skips.  Inputs are drawn as
``tests/test_kernels.py`` draws them (normal r/k/v, w = sigmoid(normal),
u = 0.1 normal), and in an extreme-decay draw: w = exp(-exp(x)) with x
uniform over [-8, 6] (w from ~0.9997 down to an underflow to 0), plus
exact 0s and values of 1 - 2**-24.  Tolerances, the
``tests/test_kernels.py`` bounds: 1e-4 in f32 (both sides keep the state
in f32 and sum in another order; the kernel's state products are 3xTF32,
which keeps f32 accuracy) and 3e-2 / 3e-1 (rtol / atol) with bf16 inputs
and outputs.  The kernel walks 16-step chunks, so T = 15, 16, 17 and the
splits at 16 and off it cover a ragged chunk, a whole one and one more.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels.ref import rwkv6_scan_ref


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(device, B, T, H, hd, dtype, seed=0, extreme=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    if extreme:
        w = np.exp(-np.exp(rng.uniform(-8.0, 6.0, (B, T, H, hd))))
        w.flat[::7] = 0.0
        w.flat[3::11] = 1.0 - 2.0 ** -24
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, hd))))
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    xs = [torch.from_numpy(a).to(device).to(dtype)
          for a in (r, k, v, w.astype(np.float32))]
    return xs + [torch.from_numpy(u).to(device),
                 torch.from_numpy(s0).to(device)]


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
            else dict(rtol=3e-2, atol=3e-1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,hd", [(1, 32, 2, 32), (2, 64, 3, 64),
                                      (2, 37, 2, 64), (3, 1, 4, 32),
                                      (1, 300, 2, 64), (2, 2, 3, 64),
                                      (2, 15, 2, 32), (2, 16, 2, 64),
                                      (2, 17, 2, 32), (1, 2048, 2, 64),
                                      (1, 2048, 2, 32)])
def test_kernel_matches_plain_version_from_zero(cuda_device, dtype, B, T, H,
                                                hd):
    r, k, v, w, u, _ = _inputs(cuda_device, B, T, H, hd, dtype, seed=T + hd)
    n0 = wkv.launches
    got = ops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv.launches == n0 + 1
    want = rwkv6_scan_ref(r, k, v, w, u)
    assert got.dtype == dtype and got.shape == r.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 16, 53])
def test_kernel_carries_the_state(cuda_device, dtype, T):
    """With an initial state: y and the final state match the plain
    version, and two calls chained through the state equal one call."""
    r, k, v, w, u, s0 = _inputs(cuda_device, 2, 2 * T, 4, 64, dtype, seed=T)
    y, s1 = ops.rwkv6_scan(r, k, v, w, u, state=s0)
    want_y, want_s = rwkv6_scan_ref(r, k, v, w, u, state=s0)
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(dtype))
    torch.testing.assert_close(s1, want_s, **_tol(torch.float32))
    y_a, s_a = ops.rwkv6_scan(*(x[:, :T].contiguous() for x in (r, k, v, w)),
                              u, state=s0)
    y_b, s_b = ops.rwkv6_scan(*(x[:, T:].contiguous() for x in (r, k, v, w)),
                              u, state=s_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1).float(), y.float(),
                               **_tol(dtype))
    torch.testing.assert_close(s_b, s1, **_tol(torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 2048])
def test_kernel_matches_plain_version_from_a_state(cuda_device, dtype, hd,
                                                   T):
    r, k, v, w, u, s0 = _inputs(cuda_device, 2, T, 3, hd, dtype, seed=T)
    y, s1 = ops.rwkv6_scan(r, k, v, w, u, state=s0)
    want_y, want_s = rwkv6_scan_ref(r, k, v, w, u, state=s0)
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(dtype))
    torch.testing.assert_close(s1, want_s, **_tol(torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [1, 17, 300, 2048])
def test_extreme_decays_stay_finite_and_match(cuda_device, hd, T):
    """Decays that underflow to 0, exact 0s and 1 - 2**-24: the running
    products give finite y and state, equal to the step loop's."""
    r, k, v, w, u, s0 = _inputs(cuda_device, 2, T, 3, hd, torch.float32,
                                seed=7 + T, extreme=True)
    assert float(w.min()) == 0.0 and float(w.max()) == 1.0 - 2.0 ** -24
    y, s1 = ops.rwkv6_scan(r, k, v, w, u, state=s0)
    want_y, want_s = rwkv6_scan_ref(r, k, v, w, u, state=s0)
    assert torch.isfinite(y).all() and torch.isfinite(s1).all()
    torch.testing.assert_close(y, want_y, **_tol(torch.float32))
    torch.testing.assert_close(s1, want_s, **_tol(torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("split", [1, 7, 16, 23, 32, 47])
def test_two_calls_equal_one_at_and_off_a_chunk_boundary(cuda_device, dtype,
                                                         split):
    r, k, v, w, u, s0 = _inputs(cuda_device, 2, 48, 3, 64, dtype, seed=split)
    y, s1 = ops.rwkv6_scan(r, k, v, w, u, state=s0)
    y_a, s_a = ops.rwkv6_scan(
        *(x[:, :split].contiguous() for x in (r, k, v, w)), u, state=s0)
    y_b, s_b = ops.rwkv6_scan(
        *(x[:, split:].contiguous() for x in (r, k, v, w)), u, state=s_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1).float(), y.float(),
                               **_tol(dtype))
    torch.testing.assert_close(s_b, s1, **_tol(torch.float32))


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    r, k, v, w, u, s0 = _inputs(cuda_device, 1, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_scan(*(x[..., :16].contiguous() for x in (r, k, v, w)),
                       u[:, :16].contiguous())
    with pytest.raises(ValueError, match="u must"):
        ops.rwkv6_scan(r, k, v, w, u.bfloat16())
    with pytest.raises(ValueError, match="state"):
        ops.rwkv6_scan(r, k, v, w, u, state=s0[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       w, u)
    with pytest.raises(ValueError, match="share a dtype"):
        ops.rwkv6_scan(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="16-byte aligned"):
        off = torch.empty(r.numel() + 1, device=cuda_device)[1:]
        ops.rwkv6_scan(off.view(r.shape).copy_(r), k, v, w, u)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rwkv6_scan(r, k, v, w, u.cpu())
