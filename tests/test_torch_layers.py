"""The port's layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the CPU, inputs made with numpy from a seed.

Float math (rmsnorm, rope, swiglu, _qkv, sdpa) agrees within 1e-5 in f32:
the two frameworks reduce and take transcendentals in their own order.
The paged stores are pure data movement (plain pools) or fixed-order
elementwise math (int8 pools), so they are held bitwise: the int8 values
and the per-page scales, with duplicate page indices and page 0's pinned
scale included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_rmsnorm():
    rng = _rng(0)
    x, scale = _normal(rng, 3, 5, 32), _normal(rng, 32)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos_shape", ["shared", "per_row"])
def test_apply_rope_split_half(pos_shape):
    rng = _rng(1)
    x = _normal(rng, 2, 6, 4, 16)
    if pos_shape == "shared":
        pos = np.arange(3, 9, dtype=np.int32)
    else:
        pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swiglu():
    rng = _rng(2)
    p = {"w1": _normal(rng, 32, 64), "w3": _normal(rng, 32, 64),
         "w2": _normal(rng, 64, 32) / 8}
    x = _normal(rng, 2, 3, 32)
    got = TL.swiglu(_t(p), torch.from_numpy(x))
    want = JL.swiglu(_j(p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True, "qk_norm": True}],
                         ids=["plain", "bias_qknorm"])
def test_qkv(extra):
    rng = _rng(3)
    tcfg, jcfg = ModelConfig(**CFG_KW, **extra), JaxConfig(**CFG_KW, **extra)
    hd = 8
    p = {"wq": _normal(rng, 32, 4 * hd), "wk": _normal(rng, 32, 2 * hd),
         "wv": _normal(rng, 32, 2 * hd)}
    if extra:
        p.update(bq=_normal(rng, 4 * hd), bk=_normal(rng, 2 * hd),
                 bv=_normal(rng, 2 * hd),
                 q_norm={"scale": _normal(rng, hd)},
                 k_norm={"scale": _normal(rng, hd)})
    x = _normal(rng, 2, 5, 32)
    pos = np.arange(7, 12, dtype=np.int32)
    got = TL._qkv(_t(p), tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL._qkv(_j(p), jcfg, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_sdpa_causal_and_batched_mask():
    rng = _rng(4)
    q, k, v = _normal(rng, 2, 5, 4, 8), _normal(rng, 2, 7, 2, 8), \
        _normal(rng, 2, 7, 2, 8)
    causal = np.arange(7)[None, :] <= np.arange(2, 7)[:, None]
    batched = rng.random((2, 5, 7)) < 0.7
    batched[..., 0] = True
    for mask in (causal, batched):
        got = TL.sdpa(*(torch.from_numpy(a) for a in (q, k, v, mask)), 2)
        want = JL.sdpa(*(jnp.asarray(a) for a in (q, k, v, mask)), 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# paged stores: bitwise
# ---------------------------------------------------------------------------

P, PS, KV, HD = 6, 4, 2, 8


def _int8_pool(rng, touched_scale=True):
    """A per-layer int8 pool as the server would hold one mid-stream:
    written bits, grown scales, page 0 pinned."""
    q = rng.integers(-127, 128, (P, PS, KV, HD)).astype(np.int8)
    scale = (rng.random(P).astype(np.float32) * 0.02 if touched_scale
             else np.full(P, 1e-8, np.float32))
    scale[0] = 1.0
    return {"q": q, "scale": scale}


def _assert_pool_equal(got, want):
    if isinstance(want, dict):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["plain", "int8", "int8_fresh"])
def test_paged_store_rows_bitwise(kind):
    """Distinct and duplicate pages, a row bound for scratch page 0, and
    rows large enough to grow some scales and too small to grow others."""
    rng = _rng(5)
    page_idx = np.array([3, 1, 3, 5, 0], np.int32)   # 3 twice, 0 = scratch
    offset = np.array([0, 2, 1, 3, 0], np.int32)
    rows = _normal(rng, 5, KV, HD) * np.array(
        [0.5, 3.0, 0.01, 1.0, 9.0], np.float32)[:, None, None]
    if kind == "plain":
        pool = _normal(rng, P, PS, KV, HD)
        jpool, tpool = jnp.asarray(pool), torch.from_numpy(pool.copy())
    else:
        pool = _int8_pool(rng, touched_scale=kind == "int8")
        jpool = _j(pool)
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    want = JL.paged_store_rows(jpool, jnp.asarray(page_idx),
                               jnp.asarray(offset), jnp.asarray(rows))
    got = TL.paged_store_rows(tpool, torch.from_numpy(page_idx),
                              torch.from_numpy(offset), torch.from_numpy(rows))
    _assert_pool_equal(got, want)
    if kind != "plain":
        assert float(got["scale"][0]) == TL.KV_SCRATCH_SCALE


@pytest.mark.parametrize("kind", ["plain", "int8", "int8_fresh"])
@pytest.mark.parametrize("pos0,T", [(0, 7), (5, 6), (4, 4), (9, 1)])
def test_paged_store_chunk_bitwise(kind, pos0, T):
    """Chunk offsets inside a page, on a page boundary, and a 1-token
    chunk; the page window's tail redirects to scratch page 0."""
    rng = _rng(6 + pos0)
    table = np.array([2, 4, 1, 5, 0, 0], np.int32)
    positions = np.arange(pos0, pos0 + T, dtype=np.int32)
    rows = _normal(rng, T, KV, HD) * 2.0
    if kind == "plain":
        pool = _normal(rng, P, PS, KV, HD)
        jpool, tpool = jnp.asarray(pool), torch.from_numpy(pool.copy())
    else:
        pool = _int8_pool(rng, touched_scale=kind == "int8")
        jpool = _j(pool)
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    want = JL.paged_store_chunk(jpool, jnp.asarray(table),
                                jnp.asarray(positions), jnp.asarray(rows))
    got = TL.paged_store_chunk(tpool, torch.from_numpy(table),
                               torch.from_numpy(positions),
                               torch.from_numpy(rows))
    _assert_pool_equal(got, want)


def test_paged_pools_init_matches_layout():
    tcfg, jcfg = ModelConfig(**CFG_KW), JaxConfig(**CFG_KW)
    for kv_dtype in (None, "int8"):
        got = TL.paged_pools_init(tcfg, 8, 4, 2, kv_dtype=kv_dtype,
                                  device="cpu")
        want = JL.paged_pools_init(jcfg, 8, 4, 2, kv_dtype=kv_dtype)
        for side in ("k", "v"):
            _assert_pool_equal(got[side], want[side])
    with pytest.raises(ValueError, match="kv_dtype"):
        TL.paged_pools_init(tcfg, 8, 4, 2, kv_dtype="fp8", device="cpu")


def test_kv_quantize_rounds_half_to_even_like_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0], np.float32)
    got = TL.kv_quantize(torch.from_numpy(x), 1.0)
    want = JL.kv_quantize(jnp.asarray(x), 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = _normal(_rng(7), 4, 8)
    assert float(TL.kv_page_scale(torch.from_numpy(s))) == float(
        JL.kv_page_scale(jnp.asarray(s)))
