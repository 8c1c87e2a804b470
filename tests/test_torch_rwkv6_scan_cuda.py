"""The CUDA RWKV-6 WKV kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_rwkv6_scan_cuda.py

Without a card every test here skips.  Inputs are drawn as
``tests/test_kernels.py`` draws them (normal r/k/v, w = sigmoid(normal),
u = 0.1 normal).  Tolerances, the ``tests/test_kernels.py`` bounds: 1e-4
in f32 (both sides keep the state in f32 and sum in another order) and
3e-2 / 3e-1 (rtol / atol) with bf16 inputs and outputs.
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


def _inputs(device, B, T, H, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
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
                                      (1, 300, 2, 64)])
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
