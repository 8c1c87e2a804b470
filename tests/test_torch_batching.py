"""The port's continuous-batching server (``repro_torch.serving.batching``)
against ``repro.serving.batching.ContinuousServer`` on the CPU.

Same config and mixed stream as ``tests/test_batching.py`` (6 requests,
3 slots, so slots retire and re-admit mid-stream), JAX weights carried
across by ``params_from_numpy``:

  * greedy tokens are identical to JAX's in the soup, member and ensemble
    modes, for a stream with a shared prefix (pages deduped), with
    ``prefill_chunk`` set, and with ``retain_pages``; the page accounting
    (allocated, shared, reused prefix tokens, LRU hits) is identical too;
  * int8 KV is held to the logit-tolerance contract (0.1, as in
    ``tests/test_batching.py``), not to token equality on a pinned stream;
  * after a stream drains, the pool holds no pages, and free + retained +
    refcounted pages add up to ``num_pages - 1`` after every step;
  * with temperature > 0 a request's tokens do not depend on its
    batch-mates (per-(request seed, step) generators);
  * the whole-prompt admit path (``attn_impl="chunked"``, whose prefill
    ``M.prefill`` computes: on the card the flash-attention kernel) gives
    JAX's greedy tokens and page accounting, shared prefix pages skipped
    by the write mask, in soup and ensemble modes, with and without
    retained pages (soup freeing its pages, the ensemble retaining them);
    it builds one admit program per prompt length, and it refuses int8 KV.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.core import population as pop
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TM
from repro_torch.serving import batching as TB
from repro_torch.serving.engine import serving_params
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
JCFG, TCFG = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
KEY = jax.random.key(0)
MIXED = [(5, 6), (9, 3), (3, 8), (12, 1), (7, 5), (4, 4)]
SERVER = dict(page_size=4, max_slots=3, num_pages=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def population():
    jpop = jax.vmap(lambda k: JM.init_params(k, JCFG))(jax.random.split(KEY, 3))
    tpop = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                             device="cpu")
    return jpop, tpop


def _mixed(seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 50, size=(S,)).astype(np.int32), mn)
            for i, (S, mn) in enumerate(MIXED)]


def _shared_prefix(seed=3):
    """Three requests on one 8-token prefix (two full pages) and one
    without; the second wave of the prefix arrives after the first."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 50, (8,)).astype(np.int32)
    tail = lambda n: rng.integers(0, 50, (n,)).astype(np.int32)  # noqa: E731
    return [("a", np.concatenate([shared, tail(3)]), 5),
            ("b", np.concatenate([shared, tail(5)]), 4),
            ("c", tail(11), 3),
            ("d", np.concatenate([shared, tail(1)]), 6)]


def _serve_both(jparams, tparams, stream, **kw):
    jserver = JB.ContinuousServer.from_trained(jparams, JCFG, **SERVER, **kw)
    tserver = TB.ContinuousServer.from_trained(tparams, TCFG, **SERVER, **kw,
                                               device="cpu")
    jout = jserver.run([JB.Request(u, p, m) for u, p, m in stream])
    tout = tserver.run([TB.Request(u, p, m) for u, p, m in stream])
    return jserver, jout, tserver, tout


def _assert_same_tokens(jout, tout):
    assert set(jout) == set(tout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid].tokens, jout[uid].tokens,
                                      err_msg=f"request {uid!r}")


def _assert_drained(server):
    p = server._pool
    assert p.used_count == 0 and not p.refcount
    assert p.free_count + p.retained_count == server.num_pages - 1
    if not p.retain:
        assert not p.prefix and p.free_count == server.num_pages - 1


@pytest.mark.parametrize("mode", ["soup", "member", "ensemble"])
def test_greedy_tokens_match_jax_on_the_mixed_stream(population, mode):
    jpop, tpop = population
    kw = {"mode": mode, "member": 1}
    jserver, jout, tserver, tout = _serve_both(jpop, tpop, _mixed(), **kw)
    _assert_same_tokens(jout, tout)
    assert tserver.stats == {k: jserver.stats[k] for k in tserver.stats}
    _assert_drained(tserver)


@pytest.mark.parametrize("mode", ["soup", "member", "ensemble"])
@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 3},
                                {"retain_pages": True, "prefill_chunk": 4}],
                         ids=["whole", "chunked", "retained"])
def test_shared_prefix_dedup_matches_jax(population, mode, kw):
    jpop, tpop = population
    jserver, jout, tserver, tout = _serve_both(
        jpop, tpop, _shared_prefix(), mode=mode, member=2, **kw)
    _assert_same_tokens(jout, tout)
    assert tserver.stats["pages_shared"] >= 2
    assert tserver.stats == {k: jserver.stats[k] for k in tserver.stats}
    _assert_drained(tserver)
    if kw.get("retain_pages"):
        # the drained pool parks the hashed prefix pages instead of freeing
        assert tserver._pool.retained_count == jserver._pool.retained_count > 0


def test_int8_kv_logits_within_tolerance_of_fp32_and_of_jax(population):
    """The int8 contract at program level: prefill a prompt into fp32 and
    int8 pools, run one decode step on each; int8 logits stay within 0.1
    of fp32 (as ``tests/test_batching.py`` pins) and within 1e-3 of JAX's
    int8 logits (one-step rounding flips of single K/V values allowed)."""
    jpop, tpop = population
    jparams = jax.tree_util.tree_map(lambda x: x[0], jpop)
    tparams = pop.member(tpop, 0)
    prompt = np.random.default_rng(30).integers(0, 50, (10,)).astype(np.int32)
    table = np.arange(1, 6, dtype=np.int32)
    outs = {}
    for kv_dtype in (None, "int8"):
        jpools = JL.paged_pools_init(JCFG, 8, 4, 2, kv_dtype=kv_dtype)
        tpools = TL.paged_pools_init(TCFG, 8, 4, 2, kv_dtype=kv_dtype,
                                     device="cpu")
        jl, jpools = JM.prefill_paged(jparams, JCFG, jnp.asarray(prompt), 0,
                                      jpools, jnp.asarray(table))
        tl, tpools = TM.prefill_paged(tparams, TCFG, torch.from_numpy(prompt),
                                      0, tpools, torch.from_numpy(table))
        tok = np.array([np.argmax(np.asarray(jl)[0, -1])], np.int32)
        js, _ = JM.decode_step_paged(jparams, JCFG, jnp.asarray(tok),
                                     jnp.array([10], jnp.int32), jpools,
                                     jnp.asarray(table)[None])
        ts, _ = TM.decode_step_paged(tparams, TCFG, torch.from_numpy(tok),
                                     torch.tensor([10], dtype=torch.int32),
                                     tpools, torch.from_numpy(table)[None])
        outs[kv_dtype] = (tl.numpy(), ts.numpy())
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-3)
    for a, b in zip(outs[None], outs["int8"]):
        np.testing.assert_allclose(b, a, rtol=0.0, atol=0.1)


@pytest.mark.parametrize("mode", ["soup", "ensemble"])
def test_int8_stream_serves_and_drains(population, mode):
    _, tpop = population
    server = TB.ContinuousServer.from_trained(tpop, TCFG, mode=mode,
                                              kv_dtype="int8", device="cpu",
                                              **SERVER)
    out = server.run([TB.Request(u, p, m) for u, p, m in _mixed()])
    for uid, prompt, mn in _mixed():
        assert out[uid].tokens.shape == (len(prompt) + mn,)
        np.testing.assert_array_equal(out[uid].tokens[:len(prompt)], prompt)
    assert server.stats["retired"] == len(MIXED)
    _assert_drained(server)


def test_pool_partition_holds_after_every_step(population):
    """free + retained + refcounted == num_pages - 1 through a stream that
    shares, parks and (in a small pool) evicts prefix pages."""
    _, tpop = population
    soup = serving_params(tpop, "soup")
    server = TB.ContinuousServer(soup, TCFG, page_size=4, max_slots=2,
                                 num_pages=12, retain_pages=True,
                                 device="cpu")
    stream = _shared_prefix() + [(f"m{u}", p, m) for u, p, m in _mixed(4)]
    for uid, prompt, mn in stream:
        server.submit(TB.Request(uid, prompt, mn))
    while server.queue_len or server.active_slots:
        server.step()
        p = server._pool
        assert (p.free_count + p.retained_count + len(p.refcount)
                == server.num_pages - 1)
    assert server.stats["retired"] == len(stream)
    _assert_drained(server)


def test_sampling_is_independent_of_batch_mates(population):
    _, tpop = population
    soup = serving_params(tpop, "soup")
    reqs = [TB.Request(u, p, m, seed=100 + u) for u, p, m in _mixed(5)]
    busy = TB.ContinuousServer(soup, TCFG, temperature=0.8, device="cpu",
                               **SERVER).run(reqs)
    for r in reqs[:3]:
        alone = TB.ContinuousServer(soup, TCFG, temperature=0.8,
                                    device="cpu", **SERVER).run([r])
        np.testing.assert_array_equal(alone[r.uid].tokens,
                                      busy[r.uid].tokens)
    with pytest.raises(ValueError, match="seed"):
        TB.ContinuousServer(soup, TCFG, temperature=0.8, device="cpu",
                            **SERVER).submit(TB.Request(0, reqs[0].tokens, 3))


def test_requests_are_validated_like_the_reference(population):
    _, tpop = population
    soup = serving_params(tpop, "soup")
    server = TB.ContinuousServer(soup, TCFG, page_size=4, max_slots=2,
                                 num_pages=8, device="cpu")
    with pytest.raises(ValueError, match="pages"):
        server.submit(TB.Request("big", np.zeros((40,), np.int32), 8))
    server.submit(TB.Request("x", np.ones((3,), np.int32), 2))
    with pytest.raises(ValueError, match="duplicate"):
        server.submit(TB.Request("x", np.ones((3,), np.int32), 2))
    assert server.cancel("x") and not server.cancel("x")
    # a chunked-attention config admits through the whole-prompt path,
    # which has no int8 store (as in the reference)
    chunked = TCFG.reduced(attn_impl="chunked")
    assert not TB.ContinuousServer(soup, chunked, device="cpu").suffix_prefill
    with pytest.raises(NotImplementedError, match="suffix-prefill"):
        TB.ContinuousServer(soup, chunked, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        TB.ContinuousServer(soup, TCFG, mode="best", device="cpu")


# ---------------------------------------------------------------------------
# the whole-prompt admit path
# ---------------------------------------------------------------------------

# one-token attention chunks: the reference's chunked prefill takes any
# prompt length then
CHUNKED_KW = dict(CFG_KW, attn_impl="chunked", attn_chunk=1)


@pytest.mark.parametrize("mode,retain", [("soup", False), ("ensemble", True)],
                         ids=["soup-freed", "ensemble-retained"])
def test_whole_prompt_admit_matches_jax(population, mode, retain):
    """The shared-prefix stream (its prefix pages deduped while the first
    holder is live, so the write mask skips them) and then the mixed one,
    through one server: tokens, stats and the pool's state equal JAX's."""
    jpop, tpop = population
    jcfg, tcfg = JaxConfig(**CHUNKED_KW), ModelConfig(**CHUNKED_KW)
    kw = dict(SERVER, mode=mode, member=0, retain_pages=retain)
    jserver = JB.ContinuousServer.from_trained(jpop, jcfg, **kw)
    TB.clear_executable_cache()
    TB.reset_trace_counts()
    tserver = TB.ContinuousServer.from_trained(tpop, tcfg, **kw,
                                               device="cpu")
    assert not tserver.suffix_prefill
    for stream in (_shared_prefix(), _mixed(7)):
        jout = jserver.run([JB.Request(u, p, m) for u, p, m in stream])
        tout = tserver.run([TB.Request(u, p, m) for u, p, m in stream])
        _assert_same_tokens(jout, tout)
        assert tserver.stats == {k: jserver.stats[k] for k in tserver.stats}
    assert tserver.stats["pages_shared"] >= 2
    assert (tserver._pool.free_count, tserver._pool.retained_count) == (
        jserver._pool.free_count, jserver._pool.retained_count)
    _assert_drained(tserver)
    lengths = {len(p) for _, p, _ in _shared_prefix() + _mixed(7)}
    assert TB.prefill_trace_count() == len(lengths)
    assert TB.decode_trace_count() == 1
