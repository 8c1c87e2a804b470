"""The port's paged attention (``repro_torch.kernels``) against the JAX
package's oracle and its Pallas kernel (interpret mode on the CPU).

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU ``ops.paged_attention`` runs the plain version; the CUDA kernel is
held to that plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_paged_attention_cuda.py``.

Tolerances: 2e-5 in f32 (the Pallas form scales q by hd**-0.5, the
oracles divide the scores by sqrt(hd), so rounding differs), 2e-2 in
bf16 (the ``tests/test_kernels.py`` bound), 2e-5 for int8 pools against
JAX's int8, and 5e-2 for int8 against the fp32 pools it quantized.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import paged_attention_ref as torch_ref

GEOMETRIES = [
    (3, 4, 2, 16, 8, 4, 3),    # GQA groups of 2, lengths across pages
    (2, 8, 8, 32, 16, 8, 4),   # MHA (g=1)
    (1, 2, 1, 8, 4, 2, 2),     # single slot, single kv head
    (4, 4, 2, 64, 32, 16, 2),  # wider pages
    (2, 6, 2, 16, 8, 4, 3),    # g=3, as llama3.2-3b
]


def _inputs(seed, B, H, KV, hd, P, ps, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pt = rng.integers(0, P, (B, mp)).astype(np.int32)
    lengths = rng.integers(1, mp * ps + 1, (B,)).astype(np.int32)
    return q, kp, vp, pt, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _quantize(pool):
    """(int8 pool, per-page scale) with page-exact scales, as
    ``tests/test_kernels.py`` builds them."""
    scale = np.maximum(np.abs(pool).max(axis=(1, 2, 3)) / np.float32(127.0),
                       np.float32(1e-8)).astype(np.float32)
    q = np.clip(np.round(pool / scale[:, None, None, None]), -127, 127)
    return q.astype(np.int8), scale


@pytest.mark.parametrize("B,H,KV,hd,P,ps,mp", GEOMETRIES)
def test_plain_version_matches_jax_oracle_and_pallas_f32(B, H, KV, hd, P, ps,
                                                         mp):
    q, kp, vp, pt, lengths = _inputs(B * 100 + hd, B, H, KV, hd, P, ps, mp)
    out = ops.paged_attention(*_torch(q, kp, vp, pt, lengths)).numpy()
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt,
                                                         lengths))))
    pallas = np.asarray(paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, lengths)), interpret=True))
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,KV,hd,P,ps,mp", GEOMETRIES[:2])
def test_plain_version_matches_jax_oracle_bf16(B, H, KV, hd, P, ps, mp):
    q, kp, vp, pt, lengths = _inputs(7 + hd, B, H, KV, hd, P, ps, mp)
    bf = ml_dtypes.bfloat16
    out = ops.paged_attention(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)],
        *_torch(pt, lengths)).float().numpy()
    want = np.asarray(jax_ref(
        *(jnp.asarray(a.astype(bf)) for a in (q, kp, vp)),
        jnp.asarray(pt), jnp.asarray(lengths))).astype(np.float32)
    np.testing.assert_allclose(out, want, rtol=2e-2, atol=2e-2)


def test_length_edges_and_garbage_past_the_length():
    """length 1, exact page multiples, and table entries past the length
    that point anywhere (here at a page full of huge values)."""
    B, H, KV, hd, P, ps, mp = 3, 2, 2, 8, 6, 4, 3
    q, kp, vp, _, _ = _inputs(3, B, H, KV, hd, P, ps, mp)
    pt = np.array([[1, 2, 3], [3, 1, 5], [5, 4, 2]], np.int32)
    for lengths in ([1, 1, 1], [ps, 2 * ps, 3 * ps], [ps + 1, 1, 2 * ps - 1]):
        lv = np.asarray(lengths, np.int32)
        out = ops.paged_attention(*_torch(q, kp, vp, pt, lv)).numpy()
        want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt,
                                                             lv))))
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[4], vp2[4] = 1e4, -1e4
    lv = np.array([ps, ps, ps], np.int32)  # page 4 only in masked tails
    out = ops.paged_attention(*_torch(q, kp2, vp2, pt, lv)).numpy()
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt, lv))))
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,KV,hd,P,ps,mp", GEOMETRIES[:2] + GEOMETRIES[4:])
def test_int8_pools_match_jax_int8(B, H, KV, hd, P, ps, mp):
    q, kp, vp, pt, lengths = _inputs(40 + hd, B, H, KV, hd, P, ps, mp)
    qk, ks = _quantize(kp)
    qv, vs = _quantize(vp)
    out = ops.paged_attention(*_torch(q, qk, qv, pt, lengths),
                              k_scale=torch.from_numpy(ks),
                              v_scale=torch.from_numpy(vs)).numpy()
    j = [jnp.asarray(a) for a in (q, qk, qv, pt, lengths)]
    want = np.asarray(jax_ref(*j, k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs)))
    pallas = np.asarray(paged_attention_pallas(
        *j, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True))
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


def test_int8_tracks_fp32_within_tolerance():
    B, H, KV, hd, P, ps, mp = 3, 4, 2, 16, 8, 4, 3
    q, kp, vp, pt, lengths = _inputs(50, B, H, KV, hd, P, ps, mp)
    qk, ks = _quantize(kp)
    qv, vs = _quantize(vp)
    exact = ops.paged_attention(*_torch(q, kp, vp, pt, lengths)).numpy()
    quant = ops.paged_attention(*_torch(q, qk, qv, pt, lengths),
                                k_scale=torch.from_numpy(ks),
                                v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(quant, exact, rtol=0.0, atol=5e-2)


def test_plain_version_is_bitwise_a_copy_of_the_ref_module():
    """``ops`` routes CPU tensors to ``kernels.ref`` unchanged."""
    args = _torch(*_inputs(5, 2, 4, 2, 16, 8, 4, 3))
    assert torch.equal(ops.paged_attention(*args), torch_ref(*args))


def test_rejects_half_specified_scales():
    q, kp, vp, pt, lengths = _torch(*_inputs(6, 1, 2, 1, 8, 4, 2, 2))
    with pytest.raises(ValueError, match="scale"):
        ops.paged_attention(q, kp, vp, pt, lengths, k_scale=torch.ones(4))
    with pytest.raises(ValueError, match="scale"):
        ops.paged_attention(q, kp, vp, pt, lengths, v_scale=torch.ones(4))
