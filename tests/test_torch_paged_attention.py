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

The CUDA kernel splits each slot's context across blocks and merges the
splits' softmax states; ``paged_attention_partials_ref`` and
``merge_partials_ref`` are the plain model of that split, held here to
the oracles (2e-5: the same f32 sums, regrouped).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import (merge_partials_ref,
                                     paged_attention_partials_ref)
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


# the split model: merging the per-split softmax states gives the oracle,
# for splits of 1, 2, 3 and all pages of the table
SPLIT_GEOMETRIES = [
    (3, 4, 2, 16, 12, 4, 7),   # 7 pages: 3 pages a split leaves a ragged one
    (2, 6, 2, 16, 10, 8, 4),   # g = 3, as llama3.2-3b
]


@pytest.mark.parametrize("split_pages", [1, 2, 3, "all"])
@pytest.mark.parametrize("B,H,KV,hd,P,ps,mp", SPLIT_GEOMETRIES)
def test_merged_partials_match_the_oracles(B, H, KV, hd, P, ps, mp,
                                           split_pages):
    q, kp, vp, pt, lengths = _inputs(80 + mp, B, H, KV, hd, P, ps, mp)
    split = (mp if split_pages == "all" else split_pages) * ps
    args = _torch(q, kp, vp, pt, lengths)
    m, l, acc = paged_attention_partials_ref(*args, split)
    n_split = -(-mp // (split // ps))
    assert m.shape == l.shape == (B, H, n_split)
    assert acc.shape == (B, H, n_split, hd)
    out = merge_partials_ref(m, l, acc, torch.float32)
    np.testing.assert_allclose(out.numpy(), torch_ref(*args).numpy(),
                               rtol=2e-5, atol=2e-5)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt,
                                                         lengths))))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)


def test_splits_past_the_length_are_empty():
    """A split that starts at or past a slot's length holds m = NEG_INF,
    l = 0 and acc = 0, and the merge skips it (its acc is never read)."""
    B, H, KV, hd, P, ps, mp = 3, 4, 2, 8, 12, 4, 6
    q, kp, vp, pt, _ = _inputs(90, B, H, KV, hd, P, ps, mp)
    lengths = np.array([1, 2 * ps, 2 * ps + 1], np.int32)
    args = _torch(q, kp, vp, pt, lengths)
    m, l, acc = paged_attention_partials_ref(*args, 2 * ps)  # 3 splits
    live = np.array([[1, 0, 0], [1, 0, 0], [1, 1, 0]], bool)
    for b in range(B):
        for s in range(3):
            if live[b, s]:
                assert (l[b, :, s] >= 1).all()
            else:
                assert (m[b, :, s] == -1e30).all() and (l[b, :, s] == 0).all()
                assert (acc[b, :, s] == 0).all()
    acc[~torch.from_numpy(live)[:, None, :, None].expand_as(acc)] = float("nan")
    out = merge_partials_ref(m, l, acc, torch.float32)
    np.testing.assert_allclose(out.numpy(), torch_ref(*args).numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_lengths_on_split_boundaries(offset):
    B, H, KV, hd, P, ps, mp = 3, 4, 2, 8, 20, 4, 6
    q, kp, vp, pt, _ = _inputs(91, B, H, KV, hd, P, ps, mp)
    split = 2 * ps
    lengths = np.array([split, 2 * split, 3 * split], np.int32) + offset
    lengths = np.clip(lengths, 1, mp * ps).astype(np.int32)
    args = _torch(q, kp, vp, pt, lengths)
    out = merge_partials_ref(*paged_attention_partials_ref(*args, split),
                             torch.float32)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt,
                                                         lengths))))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("split_pages", [1, 3])
def test_int8_partials_merge_to_jax_int8(split_pages):
    B, H, KV, hd, P, ps, mp = 2, 6, 2, 16, 10, 4, 5
    q, kp, vp, pt, lengths = _inputs(92, B, H, KV, hd, P, ps, mp)
    qk, ks = _quantize(kp)
    qv, vs = _quantize(vp)
    args = _torch(q, qk, qv, pt, lengths)
    scales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    out = merge_partials_ref(
        *paged_attention_partials_ref(*args, split_pages * ps, **scales),
        torch.float32)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, qk, qv, pt,
                                                         lengths)),
                              k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)


def test_split_geometry_comes_from_the_table_width():
    """Whole pages of at most SPLIT_TOKENS tokens a block; as many splits
    as the table's width needs (never the lengths)."""
    assert pa.SPLIT_TOKENS == 128
    assert pa.split_of(16, 72) == (128, 9)    # chip_smoke's phase-1 table
    assert pa.split_of(16, 13) == (128, 2)    # width not a multiple
    assert pa.split_of(16, 1) == (128, 1)
    assert pa.split_of(8, 33) == (128, 3)
    assert pa.split_of(256, 3) == (256, 3)    # a page longer than a split


def test_load_width_picks_the_kernel_variant():
    """16-byte runs where hd, the strides and the start allow them (8
    bytes for int8 at g > 4), else the narrow variant (1)."""
    def pools(dtype, hd=128, P=6):
        return torch.zeros((2, P, 16, 8, hd), dtype=dtype)
    f32, bf16, i8 = pools(torch.float32), pools(torch.bfloat16), pools(
        torch.int8)
    assert pa.load_width(f32[0], f32[1], 3) == 4
    assert pa.load_width(bf16[0], bf16[1], 3) == 8
    assert pa.load_width(i8[0], i8[1], 3) == 16
    assert pa.load_width(i8[0], i8[1], 8) == 8
    assert pa.load_width(*pools(torch.bfloat16, hd=64), 1) == 8
    assert pa.load_width(*pools(torch.bfloat16, hd=96), 3) == 1  # 12 lanes
    assert pa.load_width(*pools(torch.bfloat16, hd=8), 3) == 8   # 1 lane
    stacked = torch.zeros((3, 6, 16, 8, 128), dtype=torch.bfloat16)
    assert pa.load_width(stacked[1], stacked[2], 3) == 8  # a layer view
    t = bf16.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert pa.load_width(t[0], t[1], 3) == 1              # hd not unit-stride
    flat = torch.zeros(bf16.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(bf16.shape)                       # 2 bytes off
    assert pa.load_width(off[0], off[1], 3) == 1
