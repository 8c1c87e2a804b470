"""The port's telemetry primitives (``repro_torch.obs``) against
``repro.obs`` on the CPU.

The same samples go through both packages: the exact percentiles, the
bucketed histogram snapshots and their merges, ``prometheus_text``,
``summarize_samples`` and the driver's ``summarize`` on its degenerate
shapes (empty, all cancelled, zero- and one-token requests) must agree
exactly.  Then the port's own parts: sinks, events, the disabled no-op,
``configure``, the provenance record (the schema's keys, ``jax_version``
null) and the ``torch.profiler`` window's Chrome trace.
"""

import json
import os

import numpy as np
import pytest

from repro import obs as jobs
from repro.serving import driver as jdriver
from repro_torch import obs
from repro_torch.obs.metrics import Histogram, Registry
from repro_torch.serving import driver as tdriver

EDGES = (0.001, 0.01, 0.1, 1.0, 10.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.reset()
    yield
    obs.reset()


def _samples(seed, n):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(-3.0, 2.0, size=n)]


def _both_hists(values, edges=EDGES):
    t, j = Histogram("h", edges), jobs.Histogram("h", edges)
    for v in values:
        t.observe(v)
        j.observe(v)
    return t, j


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_percentiles_match_the_reference(n):
    vals = _samples(n, n) + [None, None]
    for q in (0, 1, 25, 50, 90, 99, 100):
        assert obs.percentile(vals, q) == jobs.percentile(vals, q)
        assert obs.percentile_ms(vals, q) == jobs.percentile_ms(vals, q)
    assert obs.summarize_samples(vals) == jobs.summarize_samples(vals)
    if n:
        assert obs.percentile(vals, 50) == pytest.approx(
            np.percentile([v for v in vals if v is not None], 50),
            rel=0, abs=0)
    with pytest.raises(ValueError):
        obs.percentile(vals, 101)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("edges", [EDGES, obs.DEFAULT_TIME_EDGES,
                                   obs.RATIO_EDGES])
def test_histogram_snapshots_and_merges_match(seed, edges):
    a, b, c = _samples(seed, 40), _samples(seed + 10, 3), _samples(seed + 20, 0)
    ta, ja = _both_hists(a, edges)
    tb, jb = _both_hists(b, edges)
    tc, jc = _both_hists(c, edges)
    assert ta.snapshot() == ja.snapshot()
    assert ta.merge(tb).merge(tc).snapshot() == \
        ja.merge(jb).merge(jc).snapshot()
    assert ta.merge(tb.merge(tc)).snapshot() == \
        ja.merge(jb.merge(jc)).snapshot()
    for q in (0, 50, 99, 100):
        assert ta.percentile(q) == ja.percentile(q)
    assert obs.DEFAULT_TIME_EDGES == jobs.DEFAULT_TIME_EDGES
    assert obs.RATIO_EDGES == jobs.RATIO_EDGES


def test_registry_prometheus_text_and_counters_match():
    regs = (Registry(), jobs.Registry())
    vals = _samples(5, 30)
    for reg in regs:
        acc = 0.0
        for v in vals:
            assert reg.counter("train.comm_scalars").inc(v) == acc + v
            acc += v
        reg.gauge("serve.pages_free").set(7)
        reg.gauge("serve.unset")
        h = reg.histogram("serve.ttft_s", EDGES)
        for v in vals:
            h.observe(v)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].names() == regs[1].names()
    with pytest.raises(ValueError, match="already registered"):
        regs[0].gauge("serve.ttft_s")
    with pytest.raises(ValueError, match="negative"):
        regs[0].counter("c").inc(-1)
    with pytest.raises(ValueError, match="increasing"):
        Histogram("bad", (1.0, 1.0))
    assert Registry().prometheus_text() == ""


def _metrics_pair(rows):
    """The same request timings as the port's and the reference's
    ``RequestMetrics``."""
    out = []
    for mod in (tdriver, jdriver):
        out.append({r["uid"]: mod.RequestMetrics(**r) for r in rows})
    return out


@pytest.mark.parametrize("case", ["empty", "cancelled", "zero_one_token",
                                  "mixed"])
def test_driver_summarize_matches_the_reference(case):
    rows = {
        "empty": [],
        "cancelled": [dict(uid=0, arrival=0.0, finished=1.0, cancelled=True)],
        "zero_one_token": [
            dict(uid=0, arrival=0.0, finished=0.5, first_token=None),
            dict(uid=1, arrival=0.1, first_token=0.3, finished=0.4,
                 token_times=[0.3])],
        "mixed": [
            dict(uid=u, arrival=0.1 * u, admitted=0.1 * u + 0.01,
                 first_token=0.1 * u + 0.05 + 0.01 * u,
                 finished=0.1 * u + 0.5,
                 token_times=list(np.cumsum(_samples(u, 5)) + 0.1 * u))
            for u in range(6)] + [dict(uid=9, arrival=0.2, cancelled=True,
                                       finished=0.3)],
    }[case]
    tm, jm = _metrics_pair(rows)
    assert tdriver.summarize(tm) == jdriver.summarize(jm)


def test_telemetry_sinks_events_and_spans(tmp_path):
    path = str(tmp_path / "sub" / "events.jsonl")
    tel = obs.configure(jsonl=path, memory=True)
    mem = tel._sinks[-1]
    assert isinstance(mem, obs.MemorySink)
    with tel.span("serve.decode_step", slots=3):
        pass
    tel.event("serve.request_finished", uid="a", ttft_s=0.1)
    tel.record_compile("cont_decode", slots=3)
    assert tel.registry.histogram("serve.decode_step").count == 1
    assert tel.registry.counter("compile.cont_decode").value == 1
    assert [r["kind"] for r in mem.records] == ["provenance", "span",
                                               "event", "compile"]
    assert mem.named("serve.decode_step")[0]["slots"] == 3
    tel.finalize()
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["kind"] == "provenance"
    assert {r["name"] for r in lines if r["kind"] == "metric"} == {
        "serve.decode_step", "compile.cont_decode"}
    from tools.check_metrics_schema import check_stream
    assert check_stream(path) == []


def test_disabled_telemetry_is_a_noop(tmp_path):
    tel = obs.configure(memory=True)
    tel.enabled = False
    with tel.span("x.y"):
        pass
    tel.event("x.z")
    tel.record_compile("k")
    assert tel.registry.names() == []
    assert [r["kind"] for r in tel._sinks[-1].records] == ["provenance"]


def test_configure_resets_the_default_instance():
    tel = obs.configure(memory=True)
    tel.registry.counter("a").inc()
    tel.enabled = False
    again = obs.configure()
    assert again is obs.get() is tel
    assert again.enabled and again.registry.names() == [] and not again._sinks


def test_provenance_carries_the_schema_keys():
    from tools.check_metrics_schema import PROVENANCE_FIELDS

    rec = obs.provenance()
    assert rec["kind"] == "provenance"
    for key in PROVENANCE_FIELDS:
        assert key in rec, key
    assert rec["jax_version"] is None
    assert rec["torch_version"] and rec["platform"] in ("cpu", "gpu")


def test_profile_window_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    tel = obs.configure(profile_dir=logdir, profile_spans=2)
    window = tel._profile
    assert window.active
    for i in range(3):  # the window closes itself after 2 spans
        with tel.span("train.step", step=i):
            sum(range(1000))
    assert not window.active
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "train.step" in names
    tel.finalize()
