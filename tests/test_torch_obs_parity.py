"""Instrumentation inertness in the port: telemetry-on and telemetry-off
runs give bitwise the same tokens and parameters and build the same
number of programs.

Every ``repro_torch.obs`` hook is a host-side Python effect (a registry
write, a sink append) that adds no device synchronization.  For the vmap
training loop, the scan serving engine, and the continuous server under
the request driver (plain and speculative), a run with every sink
attached must equal a run with telemetry disabled.  The train loop's
comm-volume events are the exact ``static_mix_comm`` accounting, and a
stream written by the port's train CLI passes
``tools/check_metrics_schema.py --require-comm`` run as a subprocess.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig, static_mix_comm
from repro_torch.core import population as pop
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import transformer as M
from repro_torch.serving import batching
from repro_torch.serving import engine as serving
from repro_torch.serving.driver import RequestDriver
from repro_torch.train.loop import train_population

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  d_ff=64, vocab_size=50, dtype="float32")
TCFG = TrainConfig(population=2, optimizer="sgd", lr=0.05, total_steps=4,
                   batch_size=2, seq_len=8, seed=0)
MCFG = MixingConfig(kind="wash", base_p=0.5, mode="bucketed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.reset()
    yield
    obs.reset()


def _all_sinks(tmp_path):
    """Every sink the subsystem has, all attached at once."""
    return obs.configure(jsonl=str(tmp_path / "events.jsonl"), memory=True,
                         console=True)


def _memory_sink(tel):
    return next(s for s in tel._sinks if isinstance(s, obs.MemorySink))


def _assert_trees_bitwise(a, b):
    la, lb = pop.tree_leaves(a), pop.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _train():
    def data_fn(m, step, seed):
        return concrete_batch(CFG, seed, TCFG.batch_size, TCFG.seq_len,
                              device="cpu")

    def loss_fn(params, batch):
        return M.loss_fn(params, CFG, batch)[0]

    return train_population(
        0, lambda s: M.init_params(CFG, seed=s, device="cpu"), loss_fn,
        data_fn, TCFG, MCFG, CFG.num_layers, record_every=2,
        record_fn=lambda step, p: {"probe": float(step)}, device="cpu")


def test_vmap_loop_inert_and_comm_events_exact(tmp_path):
    obs.get().enabled = False
    off = _train()
    tel = _all_sinks(tmp_path)
    on = _train()
    _assert_trees_bitwise(off.population, on.population)
    _assert_trees_bitwise(off.opt_state, on.opt_state)
    assert off.history["loss"] == on.history["loss"]
    assert off.history["probe"] == on.history["probe"]
    assert off.comm_scalars == on.comm_scalars
    assert (tel.registry.gauge("train.record.probe").value
            == on.history["probe"][-1])
    assert tel.registry.histogram("train.step").count == TCFG.total_steps

    # the comm events ARE the static accounting, replayed bit for bit
    member = pop.member(on.population, 0)
    tpl = pop.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                             device="meta"), member)
    per = static_mix_comm(tpl, MCFG, infer_layer_ids(member, CFG.num_layers),
                          total_layers(CFG.num_layers), TCFG.population)
    events = _memory_sink(tel).named("train.comm_volume")
    assert len(events) == TCFG.total_steps
    replay = 0.0
    for ev in events:
        assert ev["comm_per_mix_step"] == per
        replay += ev["comm_per_mix_step"]
        assert replay == ev["comm_total"]
    assert replay == on.comm_scalars
    assert tel.registry.counter("train.comm_scalars").value == on.comm_scalars
    tel.finalize()
    from tools.check_metrics_schema import check_stream
    assert check_stream(str(tmp_path / "events.jsonl"),
                        require_comm=True) == []


def test_scan_engine_inert(tmp_path):
    params = M.init_params(CFG, seed=0, device="cpu")
    req = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (2, 8)).astype(np.int32))}

    def run():
        serving.reset_trace_counts()
        serving.clear_executable_cache()
        out = serving.generate(params, CFG, req, 6, device="cpu")
        return out, serving.decode_trace_count(), serving.prefill_trace_count()

    obs.get().enabled = False
    out_off, dec_off, pre_off = run()
    tel = _all_sinks(tmp_path)
    out_on, dec_on, pre_on = run()
    assert torch.equal(out_off, out_on)
    assert (dec_on, pre_on) == (dec_off, pre_off) == (1, 1)
    assert tel.registry.counter("compile.serve_decode").value == 1
    assert tel.registry.counter("compile.serve_prefill").value == 1
    assert tel.registry.histogram("serve.prefill").count == 1
    assert tel.registry.histogram("serve.decode").count == 1


def _workload():
    rng = np.random.default_rng(3)
    common = rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
    reqs = []
    for i in range(5):
        body = rng.integers(0, CFG.vocab_size,
                            (int(rng.integers(2, 14)),)).astype(np.int32)
        if i % 2:
            body = np.concatenate([common, body])
        reqs.append(batching.Request(f"r{i}", body, 4 + i % 3))
    return reqs


@pytest.mark.parametrize("mode,speculative", [("soup", False),
                                              ("ensemble", True)])
def test_continuous_driver_inert(tmp_path, mode, speculative):
    popn = pop.stack([M.init_params(CFG, seed=s, device="cpu")
                      for s in (0, 1)])
    params = serving.serving_params(popn, mode)

    def run():
        batching.clear_executable_cache()
        batching.reset_trace_counts()
        server = batching.ContinuousServer(
            params, CFG, mode=mode, page_size=4, max_slots=3, num_pages=64,
            retain_pages=True, speculative=speculative, draft_k=3,
            device="cpu")
        driver = RequestDriver(server, prefill_chunk=4)
        metrics = driver.run(_workload())
        toks = {uid: m.tokens for uid, m in metrics.items()}
        return (toks, batching.decode_trace_count(),
                batching.prefill_trace_count(), dict(server.stats))

    obs.get().enabled = False
    toks_off, dec_off, pre_off, st_off = run()
    tel = _all_sinks(tmp_path)
    toks_on, dec_on, pre_on, st_on = run()
    assert toks_on.keys() == toks_off.keys()
    for uid in toks_off:
        np.testing.assert_array_equal(toks_off[uid], toks_on[uid])
    assert dec_on == dec_off == 1 and pre_on == pre_off and st_on == st_off
    reg = tel.registry
    kind = "cont_spec_decode" if speculative else "cont_decode"
    assert reg.counter(f"compile.{kind}").value == dec_on
    assert reg.counter("compile.cont_prefill_chunk").value == pre_on
    assert reg.histogram("serve.ttft_s").count == len(toks_on)
    assert reg.counter("serve.decode_steps").value == st_on["decode_steps"]
    if speculative:
        assert reg.counter("serve.spec_drafted").value == st_on["spec_drafted"]
        assert reg.histogram("serve.spec_burst").count > 0
    tel.finalize()
    from tools.check_metrics_schema import check_stream
    assert check_stream(str(tmp_path / "events.jsonl")) == []


def test_train_cli_stream_passes_the_schema_checker(tmp_path):
    out = str(tmp_path / "train.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--reduced", "--device", "cpu", "--population", "2",
         "--mode", "bucketed", "--steps", "3", "--batch-size", "2",
         "--seq-len", "8", "--metrics-out", out],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stdout + train.stderr
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_metrics_schema.py"),
         "--require-comm", out], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    assert "OK" in check.stdout
