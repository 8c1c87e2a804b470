"""The port's flash attention (``repro_torch.kernels``) against the JAX
package's Pallas kernel (interpret mode on the CPU) and its oracle.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU ``ops.flash_attention`` runs the plain version; the CUDA kernel is
held to that plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_flash_attention_cuda.py``.

Tolerances, the ``tests/test_kernels.py`` bounds: 2e-5 in f32 (the Pallas
form scales q by hd**-0.5 and streams the softmax, the plain version
divides the scores by sqrt(hd) and normalizes once, so rounding differs)
and 2e-2 in bf16 (one bf16 rounding of the output).
"""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import FLASH_F32_BK, flash_attention_3xtf32_ref


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _tol(bf16):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "B,S,H,KV,hd,bq,bk",
    [(1, 64, 4, 4, 16, 16, 16),   # MHA
     (2, 128, 4, 2, 32, 32, 64),  # GQA, uneven blocks
     (1, 96, 8, 1, 16, 32, 32)],  # MQA
)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_causal_matches_pallas(B, S, H, KV, hd, bq, bk, bf16):
    arrays = _inputs(S + hd, B, S, H, KV, hd)
    if bf16:
        arrays = [a.astype(ml_dtypes.bfloat16) for a in arrays]
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrays), block_q=bq, block_k=bk,
        interpret=True)).astype(np.float32)
    xs = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    if bf16:
        xs = [x.to(torch.bfloat16) for x in xs]
    got = ops.flash_attention(*xs)
    assert got.dtype == xs[0].dtype and got.shape == xs[0].shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(bf16))


@pytest.mark.parametrize("window", [8, 32])
def test_sliding_window_matches_pallas(window):
    q, k, v = _inputs(window, 1, 64, 4, 2, 16)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=16, block_k=16, interpret=True))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_noncausal_matches_pallas():
    q, k, v = _inputs(3, 1, 32, 2, 2, 16)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        block_q=16, block_k=16, interpret=True))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,causal,window", [(37, True, None), (50, True, 7),
                                             (29, False, None),
                                             (41, False, 9)])
def test_ragged_lengths_match_the_oracle(S, causal, window):
    """Any S (the Pallas kernel needs block multiples; its oracle does
    not): the plain version is the oracle's function."""
    q, k, v = _inputs(S, 2, S, 4, 2, 32)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_route_never_builds_the_kernel(monkeypatch):
    monkeypatch.setattr(fa, "build", lambda: pytest.fail("built"))
    n0 = fa.launches
    q, k, v = _inputs(0, 1, 8, 2, 1, 32)
    ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert fa.launches == n0 and fa._lib is None


# ---------------------------------------------------------------------------
# the float32 CUDA kernel's arithmetic (3xTF32), modelled on the CPU
# ---------------------------------------------------------------------------

def test_3xtf32_model_tiles_keys_as_the_kernel_does():
    """The model's online softmax walks the key tiles of the f32 kernel:
    ``FLASH_F32_BK`` is ``kBK`` of the source's ``namespace f32``."""
    src = fa.SOURCE.read_text()
    body = src[src.index("namespace f32 {"):src.index("}  // namespace f32")]
    assert int(re.search(r"constexpr int kBK = (\d+);", body).group(1)) \
        == FLASH_F32_BK


TF32_CASES = [
    # B, S, H, KV, hd, causal, window, block_q, block_k (of the Pallas run)
    (1, 64, 4, 4, 16, True, None, 16, 16),
    (2, 128, 4, 2, 32, True, None, 32, 64),
    (1, 96, 8, 1, 16, True, None, 32, 32),
    (1, 64, 4, 2, 16, True, 8, 16, 16),
    (1, 32, 2, 2, 16, False, None, 16, 16),
    (1, 512, 4, 2, 128, True, None, 128, 128),  # one longer row
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,bq,bk", TF32_CASES)
def test_3xtf32_model_matches_pallas(B, S, H, KV, hd, causal, window, bq, bk):
    """The CUDA f32 kernel's arithmetic (``flash_attention_3xtf32_ref``:
    TF32 split emulated on the int32 view, three products per float32
    product, the online softmax over 64-key tiles in base 2) holds the
    float32 bound of 2e-5 against the Pallas kernel in interpret mode.
    One TF32 product instead would not (see the next test)."""
    q, k, v = _inputs(S + hd + 1, B, S, H, KV, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True))
    got = flash_attention_3xtf32_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_one_tf32_product_breaks_the_f32_bound():
    """A row of S=512, hd=128 (B=1, 4 heads over 2, causal): one TF32
    product per product (``products=1``) lands 1.24e-3 from the plain
    version, 62x the 2e-5 float32 bound; 3xTF32 lands 9.5e-7 from it (the
    CPU model's numbers at this seed).  That is why the kernel takes
    three products, and why TF32 alone was ruled out."""
    q, k, v = map(torch.from_numpy, _inputs(641, 1, 512, 4, 2, 128))
    want = ops.flash_attention(q, k, v)
    one = flash_attention_3xtf32_ref(q, k, v, products=1)
    three = flash_attention_3xtf32_ref(q, k, v)
    assert float((one - want).abs().max()) > 2e-5
    assert float((three - want).abs().max()) < 2e-6
