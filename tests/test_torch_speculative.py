"""Population speculative decoding in the port
(``repro_torch.serving.speculative``) against ``repro.serving`` on the
CPU.

Same config, pool geometry and streams as
``tests/test_speculative_properties.py``, a diverse population (JAX's
``split(key(1), 3)`` members, carried across by ``params_from_numpy``) so
the soup's drafts do get rejected and the rollback (``_shrink``) runs:

  * greedy tokens, ``spec_drafted``/``spec_accepted`` and the page
    accounting equal JAX's, in soup and ensemble modes, for draft lengths
    k in {1, 3, 8};
  * at float32 KV the speculative stream equals the port's own plain
    (non-speculative) stream token for token, greedy AND at temperature
    0.8 (each verified token drawn at its plain step's generator), and
    the pool drains with no page held;
  * int8 KV: the speculative stream equals the plain int8 stream on
    ``tests/test_batching.py``'s pinned stream, its bound for speculative
    int8; and the verify's store of several rows into one int8 page
    equals JAX's ``paged_store_rows`` bit for bit;
  * ``speculative_supported`` refuses exactly the configs the reference
    refuses, and the server refuses them up front.

Hypothesis properties on the port's own streams use ``max_examples=8,
derandomize=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import layers as JL
from repro.models import transformer as JM
from repro.serving import batching as JB
from repro.serving import speculative as JS
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.serving import batching as TB
from repro_torch.serving import speculative as TS
from repro_torch.serving.driver import RequestDriver
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
JCFG, TCFG = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
JPOP = jax.vmap(lambda k: JM.init_params(k, JCFG))(
    jax.random.split(jax.random.key(1), 3))
TPOP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPOP),
                         device="cpu")
PAGE_SIZE, MAX_SLOTS, NUM_PAGES = 4, 3, 64
GEO = dict(page_size=PAGE_SIZE, max_slots=MAX_SLOTS, num_pages=NUM_PAGES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_stream(seed, n):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 50, (int(rng.integers(1, 18)),)).astype(np.int32)
               for _ in range(n)]
    max_news = [int(rng.integers(1, 9)) for _ in range(n)]
    return prompts, max_news


def _serve(prompts, max_news, *, mode, temperature=0.0, **kw):
    server = TB.ContinuousServer.from_trained(
        TPOP, TCFG, mode=mode, temperature=temperature, device="cpu",
        **GEO, **kw)
    out = server.run([TB.Request(u, p, mn, seed=1000 + u)
                      for u, (p, mn) in enumerate(zip(prompts, max_news))])
    return out, server


def _assert_drained(server):
    pool = server._pool
    assert not pool.refcount, f"leaked refcounts at drain: {pool.refcount}"
    assert (pool.free_count + pool.retained_count + len(pool.refcount)
            == NUM_PAGES - 1)


@pytest.mark.parametrize("draft_k", [1, 3, 8])
@pytest.mark.parametrize("mode", ["soup", "ensemble"])
def test_greedy_tokens_and_spec_stats_match_jax(mode, draft_k):
    prompts, max_news = _make_stream(200, 5)
    kw = dict(mode=mode, speculative=True, draft_k=draft_k, prefill_chunk=4)
    jserver = JB.ContinuousServer.from_trained(JPOP, JCFG, **GEO, **kw)
    jout = jserver.run([JB.Request(u, p, mn) for u, (p, mn)
                        in enumerate(zip(prompts, max_news))])
    tout, tserver = _serve(prompts, max_news, **kw)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid].tokens, jout[uid].tokens,
                                      err_msg=f"uid {uid}")
    assert tserver.stats == {k: jserver.stats[k] for k in tserver.stats}
    if mode == "ensemble" and draft_k > 1:
        st = tserver.stats
        assert 0 < st["spec_accepted"] < st["spec_drafted"], (
            "the diverse population must reject some drafts, or the "
            "rollback path is not exercised")
    _assert_drained(tserver)


def _check_parity(prompts, max_news, *, mode, temperature, draft_k,
                  kv_dtype=None, plain=None):
    if plain is None:
        plain, _ = _serve(prompts, max_news, mode=mode,
                          temperature=temperature, kv_dtype=kv_dtype)
    spec, server = _serve(prompts, max_news, mode=mode,
                          temperature=temperature, kv_dtype=kv_dtype,
                          speculative=True, draft_k=draft_k)
    assert sorted(spec) == sorted(plain)
    for uid in plain:
        np.testing.assert_array_equal(
            plain[uid].tokens, spec[uid].tokens,
            err_msg=f"uid {uid} (mode={mode}, T={temperature}, "
                    f"k={draft_k}, kv={kv_dtype}): speculative != plain")
        assert len(spec[uid].tokens) == len(prompts[uid]) + max_news[uid]
    _assert_drained(server)
    return server


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", ["soup", "ensemble"])
def test_speculative_equals_plain_at_f32(mode, temperature):
    """One plain stream against speculation at every draft length."""
    prompts, max_news = _make_stream(201, 5)
    plain, _ = _serve(prompts, max_news, mode=mode, temperature=temperature)
    for draft_k in (1, 3, 8):
        _check_parity(prompts, max_news, mode=mode, temperature=temperature,
                      draft_k=draft_k, plain=plain)


def test_budget_clamp_with_draft_longer_than_budgets():
    prompts, _ = _make_stream(202, 4)
    _check_parity(prompts, [1, 2, 1, 3], mode="soup", temperature=0.0,
                  draft_k=TS.MAX_DRAFT_K)


def test_int8_speculative_matches_plain_int8_on_the_pinned_stream():
    """``tests/test_batching.py``'s pinned stream and params (JAX's
    ``key(0)``), soup mode, draft_k 4: the bound that test holds
    speculative int8 to is token equality with the plain int8 server."""
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.key(0), JCFG)), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [TB.Request(i, rng.integers(0, 50, (S,)).astype(np.int32), mn)
            for i, (S, mn) in enumerate([(5, 6), (9, 3), (3, 8), (12, 1),
                                          (7, 5), (4, 4)])]
    geo = dict(page_size=4, max_slots=3, num_pages=32, kv_dtype="int8",
               device="cpu")
    plain = TB.ContinuousServer(params, TCFG, **geo).run(reqs)
    spec = TB.ContinuousServer(params, TCFG, speculative=True, draft_k=4,
                               **geo)
    out = spec.run(reqs)
    for uid in plain:
        np.testing.assert_array_equal(plain[uid].tokens, out[uid].tokens)
    assert spec._pool.used_count == 0
    assert spec.stats["spec_drafted"] >= spec.stats["spec_accepted"] >= 0


def test_int8_store_of_several_rows_in_one_page_matches_jax():
    """The verify's scatter: B*k rows, several in one page (two slots'
    k=4 rows across page boundaries) and the invalid rows' duplicate
    writes of scratch (0, 0), into pools that already hold rows."""
    rng = np.random.default_rng(9)
    P, ps, KV, hd = 6, 4, 2, 8
    q0 = rng.integers(-100, 100, (P, ps, KV, hd)).astype(np.int8)
    s0 = np.abs(rng.standard_normal(P)).astype(np.float32) * 0.01
    s0[0] = TL.KV_SCRATCH_SCALE
    page_idx = np.array([2, 2, 2, 3, 4, 4, 0, 0], np.int32)
    offset = np.array([1, 2, 3, 0, 2, 3, 0, 0], np.int32)
    rows = (rng.standard_normal((8, KV, hd)) * 3).astype(np.float32)
    jout = JL.paged_store_rows({"q": jnp.asarray(q0), "scale": jnp.asarray(s0)},
                               jnp.asarray(page_idx), jnp.asarray(offset),
                               jnp.asarray(rows))
    tpool = {"q": torch.from_numpy(q0.copy()),
             "scale": torch.from_numpy(s0.copy())}
    TL.paged_store_rows(tpool, torch.from_numpy(page_idx),
                        torch.from_numpy(offset), torch.from_numpy(rows))
    np.testing.assert_array_equal(tpool["scale"].numpy(),
                                  np.asarray(jout["scale"]))
    live = np.ones(P, bool)
    live[0] = False  # scratch: which duplicate lands is unspecified
    np.testing.assert_array_equal(tpool["q"].numpy()[live],
                                  np.asarray(jout["q"])[live])


_CONFIGS = {
    "dense": {},
    "chunked": {"attn_impl": "chunked"},
    "moe": {"moe": True, "n_routed_experts": 4, "top_k": 2},
    "window": {"window": 8},
    "mla": {"mla": True, "kv_lora_rank": 16, "qk_nope_dim": 8,
            "qk_rope_dim": 8, "v_head_dim": 8},
    "rwkv6": {"block_kind": "rwkv6"},
    "vision": {"frontend": "vision", "num_patches": 3},
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_speculative_supported_refuses_what_the_reference_refuses(name):
    kw = dict(CFG_KW, **_CONFIGS[name])
    ref = JS.speculative_supported(JaxConfig(**kw))
    got = TS.speculative_supported(ModelConfig(**kw))
    assert (got is None) == (ref is None), (got, ref)
    if name == "dense":
        return
    soup = TB.serving_params(TPOP, "soup")
    with pytest.raises(NotImplementedError):
        TB.ContinuousServer(soup, ModelConfig(**kw), speculative=True,
                            device="cpu")


def test_speculative_server_refuses_bad_draft_lengths():
    soup = TB.serving_params(TPOP, "soup")
    with pytest.raises(ValueError, match="draft_k"):
        TB.ContinuousServer(soup, TCFG, speculative=True, draft_k=0,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="speculative"):
        TB.ContinuousServer(soup, ModelConfig(**CFG_KW, attn_impl="chunked"),
                            speculative=True, device="cpu")


def test_staggered_admissions_through_the_driver():
    """Chunked-prefill driver admissions land mid-stream, so one verify
    step mixes slots at different depths, some freshly admitted."""
    prompts, max_news = _make_stream(204, 6)

    def drive(speculative):
        server = TB.ContinuousServer.from_trained(
            TPOP, TCFG, mode="ensemble", speculative=speculative, draft_k=4,
            device="cpu", **GEO)
        driver = RequestDriver(server, prefill_chunk=4)
        for u, (p, mn) in enumerate(zip(prompts, max_news)):
            driver.submit(TB.Request(u, p, mn))
        return driver.drain(), server

    plain, _ = drive(False)
    spec, server = drive(True)
    for uid in plain:
        np.testing.assert_array_equal(plain[uid].tokens, spec[uid].tokens)
    _assert_drained(server)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # a dev-only dependency
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @st.composite
    def spec_cases(draw):
        n = draw(st.integers(1, 5))
        seed = draw(st.integers(0, 2**31 - 1))
        draft_k = draw(st.integers(1, TS.MAX_DRAFT_K))
        mode = draw(st.sampled_from(["soup", "ensemble"]))
        temperature = draw(st.sampled_from([0.0, 0.8]))
        return n, seed, draft_k, mode, temperature

    @given(spec_cases())
    @settings(max_examples=8, deadline=None, derandomize=True)
    def test_random_streams_match_plain_decode(case):
        n, seed, draft_k, mode, temperature = case
        prompts, max_news = _make_stream(seed, n)
        _check_parity(prompts, max_news, mode=mode, temperature=temperature,
                      draft_k=draft_k)
