"""The port's request driver (``repro_torch.serving.driver``) against
``repro.serving.driver`` on the CPU.

Same config, pool geometry and fixed streams as
``tests/test_driver_properties.py`` (a prefix family under chunked
prefill, whole-prompt prefill, cancellations at every stage, FIFO under
slot pressure, backpressure), JAX weights carried across by
``params_from_numpy``.  Both drivers tick in lock step under the same
cancellation schedule; per stream:

  * every finished request's greedy tokens, and the tokens streamed to
    its ``on_token`` callback, equal JAX's;
  * ``admitted_order`` equals JAX's (and is FIFO), and so do the server's
    page and admission stats (allocated, shared, reused prefix tokens,
    LRU hits, cancellations);
  * at drain the pool holds no reference and free + parked + refcounted
    pages add up to the pool.

The whole-prompt admit path (``attn_impl="chunked"``) runs the prefix
family through both drivers too.  Then the port's own parts: hypothesis
properties on its own streams (each request equal to serving it alone
through ``engine.generate_reference``; ``max_examples=8``,
``derandomize=True``), the timed ``run`` with ``poisson_arrivals`` (the
same arrival times as JAX's), and the pump thread behind ``astream``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import transformer as JM
from repro.serving import batching as JB
from repro.serving import driver as JD
from repro_torch.configs.base import ModelConfig
from repro_torch.serving import batching as TB
from repro_torch.serving import driver as TD
from repro_torch.serving import engine as TE
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
JCFG, TCFG = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
JPARAMS = JM.init_params(jax.random.key(0), JCFG)
TPARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS),
                            device="cpu")
PAGE_SIZE, MAX_SLOTS, NUM_PAGES = 4, 3, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_prompts(spec_seed, n, prefix_family):
    """``tests/test_driver_properties.py``'s prompts: odd-indexed
    requests share a two-page prefix when ``prefix_family`` is set."""
    rng = np.random.default_rng(spec_seed)
    common = rng.integers(0, 50, (2 * PAGE_SIZE,)).astype(np.int32)
    prompts = []
    for i in range(n):
        body = rng.integers(0, 50, (int(rng.integers(1, 21)),)).astype(np.int32)
        if prefix_family and i % 2 == 1:
            body = np.concatenate([common, body])
        prompts.append(body)
    return prompts


def _drive(B, D, params, cfg, prompts, max_news, chunk, cancels, retain,
           max_queued_tokens=None):
    server = B.ContinuousServer(params, cfg, page_size=PAGE_SIZE,
                                max_slots=MAX_SLOTS, num_pages=NUM_PAGES,
                                retain_pages=retain,
                                **({"device": "cpu"} if B is TB else {}))
    driver = D.RequestDriver(server, prefill_chunk=chunk,
                             max_queued_tokens=max_queued_tokens)
    streamed, rejected = {}, []
    for uid, (p, mn) in enumerate(zip(prompts, max_news)):
        toks = []
        try:
            driver.submit(B.Request(uid, p, mn),
                          on_token=lambda u, t, acc=toks: acc.append(t))
        except D.QueueFull:
            rejected.append(uid)
            continue
        streamed[uid] = toks
    cancels = dict(cancels)
    ticks = 0
    while driver.has_work:
        for uid, at in list(cancels.items()):
            if ticks >= at:
                driver.cancel(uid)
                del cancels[uid]
        driver.tick()
        ticks += 1
        assert ticks < 10_000, "driver failed to drain"
    return driver, server, streamed, rejected


def _both(prompts, max_news, chunk, cancels=(), retain=True, cfg_kw=None,
          **kw):
    jcfg, tcfg = ((JaxConfig(**CFG_KW, **cfg_kw), ModelConfig(**CFG_KW,
                                                              **cfg_kw))
                  if cfg_kw else (JCFG, TCFG))
    j = _drive(JB, JD, JPARAMS, jcfg, prompts, max_news, chunk, cancels,
               retain, **kw)
    t = _drive(TB, TD, TPARAMS, tcfg, prompts, max_news, chunk, cancels,
               retain, **kw)
    (jd, js, jstream, jrej), (td, ts, tstream, trej) = j, t
    assert trej == jrej
    assert td.admitted_order == jd.admitted_order
    assert td.admitted_order == sorted(td.admitted_order)
    assert set(td.metrics) == set(jd.metrics)
    for uid, m in jd.metrics.items():
        tm = td.metrics[uid]
        assert tm.cancelled == m.cancelled
        if m.cancelled:
            continue
        np.testing.assert_array_equal(tm.tokens, m.tokens,
                                      err_msg=f"uid {uid}")
        assert tstream[uid] == jstream[uid]
        np.testing.assert_array_equal(
            np.asarray(tstream[uid], np.int32), tm.tokens[len(prompts[uid]):])
    assert ts.stats == {k: js.stats[k] for k in ts.stats}
    pool = ts._pool
    assert not pool.refcount
    assert (pool.free_count + pool.retained_count + len(pool.refcount)
            == NUM_PAGES - 1)
    assert (pool.free_count, pool.retained_count) == (
        js._pool.free_count, js._pool.retained_count)
    return td, ts


@pytest.mark.parametrize("attn", ["naive", "chunked"])
def test_fixed_mixed_stream_with_prefix_family(attn):
    prompts = _make_prompts(100, 5, prefix_family=True)
    cfg_kw = {"attn_impl": "chunked", "attn_chunk": 1} if attn == "chunked" \
        else None
    _, server = _both(prompts, [6, 3, 1, 8, 4], chunk=4, cfg_kw=cfg_kw)
    assert server.suffix_prefill == (attn == "naive")
    assert server.stats["pages_shared"] > 0


def test_fixed_whole_prompt_stream():
    _both(_make_prompts(101, 4, prefix_family=False), [5, 1, 4, 2],
          chunk=None)


def test_fixed_cancellations_at_every_stage():
    drv, server = _both(_make_prompts(102, 5, prefix_family=True),
                        [4, 6, 3, 8, 2], chunk=2, cancels=((1, 0), (3, 4)))
    assert drv.metrics[1].cancelled and drv.metrics[3].cancelled
    assert server.stats["cancelled"] >= 1


def test_fixed_fifo_under_slot_pressure():
    rng = np.random.default_rng(103)
    prompts = [rng.integers(0, 50, (s,)).astype(np.int32)
               for s in (20, 3, 3, 3, 3, 3)]
    drv, _ = _both(prompts, [4] * 6, chunk=2)
    assert drv.admitted_order == [0, 1, 2, 3, 4, 5]


def test_fixed_backpressure_is_fifo_and_recoverable():
    rng = np.random.default_rng(104)
    prompts = [rng.integers(0, 50, (12,)).astype(np.int32) for _ in range(3)]
    drv, _ = _both(prompts, [6, 6, 6], chunk=3, max_queued_tokens=40)
    assert drv.admitted_order == [0, 1] and 2 not in drv.metrics
    server = TB.ContinuousServer(TPARAMS, TCFG, device="cpu")
    small = TD.RequestDriver(server, max_queued_tokens=5)
    small.submit(TB.Request("big", prompts[0], 6))  # alone: still accepted
    with pytest.raises(TD.QueueFull):
        small.submit(TB.Request("next", prompts[1], 6))


# ---------------------------------------------------------------------------
# the port's own streams: solo parity and the driver's invariants
# ---------------------------------------------------------------------------

_SOLO = {}


def _solo(prompt, max_new):
    key = (prompt.tobytes(), max_new)
    if key not in _SOLO:
        _SOLO[key] = TE.generate_reference(
            TPARAMS, TCFG, {"tokens": torch.from_numpy(prompt)[None]},
            max_new, device="cpu")[0].numpy()
    return _SOLO[key]


def _check_solo(prompts, max_news, chunk, cancels=()):
    TB.clear_executable_cache()
    TB.reset_trace_counts()
    drv, server, streamed, _ = _drive(TB, TD, TPARAMS, TCFG, prompts,
                                      max_news, chunk, cancels, True)
    for uid, (p, mn) in enumerate(zip(prompts, max_news)):
        m = drv.metrics[uid]
        if m.cancelled:
            assert m.tokens is None
            continue
        np.testing.assert_array_equal(_solo(p, mn), m.tokens,
                                      err_msg=f"uid {uid} chunk {chunk}")
        assert streamed[uid] == list(m.tokens[len(p):])
        assert m.arrival <= m.admitted <= m.first_token <= m.finished
        assert len(m.token_times) == mn
    assert drv.admitted_order == sorted(drv.admitted_order)
    pool = server._pool
    assert not pool.refcount
    assert (pool.free_count + pool.retained_count == NUM_PAGES - 1)
    # one decode program for the geometry; chunk programs by length
    assert TB.decode_trace_count() <= 1
    if chunk is not None:
        assert TB.prefill_trace_count() <= chunk


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # a dev-only dependency
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    SETTINGS = dict(max_examples=8, deadline=None, derandomize=True)

    @st.composite
    def stream_cases(draw):
        n = draw(st.integers(1, 5))
        seed = draw(st.integers(0, 2**31 - 1))
        prefix_family = draw(st.booleans())
        chunk = draw(st.sampled_from([None, 2, 4, 7]))
        max_news = [draw(st.integers(1, 6)) for _ in range(n)]
        return n, seed, prefix_family, chunk, max_news

    @given(stream_cases(), st.data())
    @settings(**SETTINGS)
    def test_random_streams_equal_solo_serving(case, data):
        n, seed, prefix_family, chunk, max_news = case
        uids = data.draw(st.sets(st.integers(0, n - 1), max_size=2))
        cancels = tuple((u, data.draw(st.integers(0, 6))) for u in uids)
        _check_solo(_make_prompts(seed, n, prefix_family), max_news, chunk,
                    cancels)


def test_fixed_stream_equals_solo_serving():
    _check_solo(_make_prompts(105, 5, prefix_family=True), [3, 1, 5, 2, 4],
                chunk=3, cancels=((2, 1),))


def test_timed_run_with_poisson_arrivals():
    prompts = _make_prompts(106, 4, prefix_family=True)
    treqs = [TB.Request(u, p, 3) for u, p in enumerate(prompts)]
    jreqs = [JB.Request(u, p, 3) for u, p in enumerate(prompts)]
    tarr = TD.poisson_arrivals(treqs, rate=200.0, seed=7)
    jarr = JD.poisson_arrivals(jreqs, rate=200.0, seed=7)
    assert [t for t, _ in tarr] == [t for t, _ in jarr]
    server = TB.ContinuousServer(TPARAMS, TCFG, page_size=PAGE_SIZE,
                                 max_slots=MAX_SLOTS, num_pages=NUM_PAGES,
                                 retain_pages=True, device="cpu")
    metrics = TD.RequestDriver(server, prefill_chunk=4).run(tarr)
    for (t, req), uid in zip(tarr, range(len(prompts))):
        np.testing.assert_array_equal(metrics[uid].tokens,
                                      _solo(req.tokens, 3))
    s = TD.summarize(metrics)
    assert s["requests"] == len(prompts) and s["generated_tokens"] == 12
    assert s["ttft_p50_ms"] <= s["ttft_p99_ms"] <= s["latency_p99_ms"]
    assert s["tokens_per_s"] > 0


def test_pump_thread_streams_through_astream():
    prompts = _make_prompts(107, 3, prefix_family=False)
    server = TB.ContinuousServer(TPARAMS, TCFG, page_size=PAGE_SIZE,
                                 max_slots=MAX_SLOTS, num_pages=NUM_PAGES,
                                 device="cpu")
    driver = TD.RequestDriver(server, prefill_chunk=4)

    async def consume():
        async def one(uid, p):
            return [t async for t in driver.astream(TB.Request(uid, p, 4))]
        return await asyncio.gather(*[one(u, p)
                                      for u, p in enumerate(prompts)])

    driver.start()
    try:
        got = asyncio.run(consume())
    finally:
        driver.stop()
    assert driver._pump is None and not driver.has_work
    for p, toks in zip(prompts, got):
        assert toks == list(_solo(p, 4)[len(p):])


def test_serve_cli_driver_speculative_and_telemetry(tmp_path, capsys):
    from repro_torch.launch import serve
    from tools.check_metrics_schema import check_stream

    out = str(tmp_path / "serve.jsonl")
    metrics, summary = serve.main([
        "--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
        "--population", "2", "--mode", "ensemble", "--driver",
        "--arrival-rate", "500", "--prefill-chunk", "8", "--retain-pages",
        "--speculative", "--draft-k", "3", "--requests", "6",
        "--seq-len", "24", "--max-new", "6", "--metrics-out", out])
    text = capsys.readouterr().out
    assert "ttft p50" in text and "speculative draft_k=3" in text
    assert summary["requests"] == 6 and len(metrics) == 6
    assert check_stream(out) == []
    for bad in (["--speculative"], ["--kv-dtype", "int8"],
                ["--driver", "--compare"], ["--continuous", "--draft-k", "0"]):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "llama3.2-3b", "--reduced", "--device",
                        "cpu"] + bad)


def test_serve_cli_quick_trains_the_population_it_serves(tmp_path, capsys):
    """``--train-steps`` serves the population that the reference's
    quick-train recipe gives (bucketed WASH at p = 0.05, SGD at lr 0.05,
    8 x 32 tokens a member of the synthetic LM task), written out here and
    served again through ``--ckpt``; training moved the weights."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.core.prng import fold_in
    from repro_torch.data import make_lm_task, sample_tokens
    from repro_torch.launch import serve
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import train_population

    cfg, seed, steps = get_arch("llama3.2-3b").reduced(), 3, 2
    task = make_lm_task(fold_in(seed, 1), vocab=min(cfg.vocab_size, 512),
                        device="cpu")

    def data_fn(m, step, s):
        b = concrete_batch(cfg, fold_in(s, 10), 8, 32, device="cpu")
        b["tokens"] = sample_tokens(task, s, 8, 32) % cfg.vocab_size
        return b

    res = train_population(
        seed, lambda s: M.init_params(cfg, seed=s, device="cpu"),
        lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn,
        TrainConfig(population=2, optimizer="sgd", lr=0.05,
                    total_steps=steps),
        MixingConfig(kind="wash", base_p=0.05, mode="bucketed"),
        cfg.num_layers, record_every=1, device="cpu")
    ckpt = checkpoint.save(str(tmp_path / "popn.npz"), res.population)
    init = serve.init_population(cfg, 2, seed, "cpu")
    assert not torch.equal(res.population["embed"]["tok"],
                           init["embed"]["tok"])

    argv = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--population", "2", "--mode", "ensemble", "--continuous",
            "--requests", "3", "--seq-len", "16", "--max-new", "4",
            "--seed", str(seed)]
    trained = serve.main(argv + ["--train-steps", str(steps)])
    assert f"quick-trained {steps} steps" in capsys.readouterr().out
    restored = serve.main(argv + ["--ckpt", ckpt])
    assert trained.keys() == restored.keys() and len(trained) == 3
    for uid, r in trained.items():
        np.testing.assert_array_equal(r.tokens, restored[uid].tokens)


def test_pump_thread_failure_reaches_astream_and_stop():
    """A tick that raises on the pump thread ends every ``astream``
    consumer with the error, and ``stop`` re-raises it."""
    server = TB.ContinuousServer(TPARAMS, TCFG, page_size=PAGE_SIZE,
                                 max_slots=MAX_SLOTS, num_pages=NUM_PAGES,
                                 device="cpu")
    driver = TD.RequestDriver(server, prefill_chunk=4)

    def broken_step(*args, **kwargs):
        raise ValueError("launch failed")

    server.step = broken_step
    prompts = _make_prompts(108, 2, prefix_family=False)

    async def consume():
        async def one(uid, p):
            return [t async for t in driver.astream(TB.Request(uid, p, 4))]
        return await asyncio.gather(*[one(u, p)
                                      for u, p in enumerate(prompts)],
                                    return_exceptions=True)

    driver.start()
    got = asyncio.run(asyncio.wait_for(consume(), timeout=60))
    for err in got:
        assert isinstance(err, RuntimeError)
        assert isinstance(err.__cause__, ValueError)
    with pytest.raises(RuntimeError) as info:
        driver.stop()
    assert "launch failed" in str(info.value.__cause__)
    assert driver._pump is None and not driver._waiters


# ---------------------------------------------------------------------------
# a request that reuses a finished request's uid
# ---------------------------------------------------------------------------


def _server(chunk):
    return TB.ContinuousServer(TPARAMS, TCFG, page_size=PAGE_SIZE,
                               max_slots=MAX_SLOTS, num_pages=NUM_PAGES,
                               prefill_chunk=chunk, device="cpu")


def _reused_pair():
    first, second = _make_prompts(109, 2, prefix_family=False)
    return (TB.Request(7, first, 3), TB.Request(7, second, 3))


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
def test_step_returns_the_uids_retired_in_that_step(chunk):
    """``step()`` reports a uid when its request retires in that step,
    also when a finished request used the uid before."""
    server = _server(chunk)
    for req in _reused_pair():
        server.submit(req)
        seen = []
        while server._queue or server.active_slots:
            seen.append(server.step())
        assert [u for uids in seen for u in uids] == [7]
        assert seen[-1] == [7]
        np.testing.assert_array_equal(server._results[7].tokens,
                                      _solo(req.tokens, 3))
    assert server.stats["retired"] == 2


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
def test_reused_uid_finishes_through_run_and_the_driver(chunk):
    first, second = _reused_pair()
    server = _server(chunk)
    assert 7 in server.run([first])
    out = server.run([second])
    np.testing.assert_array_equal(out[7].tokens, _solo(second.tokens, 3))

    finished = []
    driver = TD.RequestDriver(_server(chunk), prefill_chunk=chunk)
    for req in (first, second):
        driver.submit(req, on_finish=lambda uid, res: finished.append(
            (uid, res.tokens.copy())))
        driver.drain()
    assert [u for u, _ in finished] == [7, 7]
    for (_, toks), req in zip(finished, (first, second)):
        np.testing.assert_array_equal(toks, _solo(req.tokens, 3))
    assert not driver.has_work


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
def test_reused_uid_finishes_through_astream(chunk):
    first, second = _reused_pair()
    driver = TD.RequestDriver(_server(chunk), prefill_chunk=chunk)

    async def consume():
        out = []
        for req in (first, second):
            out.append([t async for t in driver.astream(req)])
        return out

    driver.start()
    try:
        got = asyncio.run(asyncio.wait_for(consume(), timeout=60))
    finally:
        driver.stop()
    for toks, req in zip(got, (first, second)):
        assert toks == list(_solo(req.tokens, 3)[len(req.tokens):])
