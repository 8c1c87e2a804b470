"""The ensemble engine (``train_population(engine="shard_map")``) on the CPU.

On ``tests/test_distributed.py``'s toy model (embed 16x8, one 8x8 block,
head 8x4; N = 4, 11 steps, a record every 5):

  * at world 1 against JAX's vmap loop, JAX's plans crossed in as data
    through a monkeypatched ``make_plan``: WASH+Opt under AdamW, PAPA
    (``papa_every=2``) and ``none``; losses within 1e-5, params within
    1e-4, comm and the history's steps exactly;
  * at world 1 against the port's own vmap loop, bitwise;
  * the chunk functions it builds: 1 for WASH and ``none``, one a
    variant of the schedule for PAPA (2, with the gate split or not);
  * across ranks, one spawn of 4 ``gloo`` ranks (``torch_ring_worker.py``):
    worlds 2 and 4 gathered on rank 0 equal world 1 bitwise for WASH,
    ``none`` and PAPA (its mean is summed in float64, exactly, so the
    order of the adds across ranks does not show), with the same comm;
  * the train CLI at ``--reduced --device cpu``: ``--engine shard_map``
    prints the loss, consensus and comm of ``--engine vmap``, on the
    ``ens`` mesh and on the (1, 1, 1) ``ens_dp_mp`` mesh; dense WASH is
    switched to bucketed with a note; a pipe axis past 1 is refused; its
    telemetry stream passes the schema checker;
  * refusals, before any parameter is made: a population that does not
    divide over the world, more ranks than cards on ``cuda``, dense WASH,
    ``param_specs`` without a multi-axis mesh, pipeline stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import mixing as jmix
from repro.core import population as jpop
from repro.core import shuffle as jshf
from repro.core.layer_index import infer_layer_ids as jlids
from repro.core.layer_index import total_layers as jtotal
from repro.core.prng import step_key
from repro.train import loop as jloop

import torch_ring_worker as W
from repro_torch.configs.base import TrainConfig
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as train_cli
from repro_torch.train import engine
from repro_torch.train import loop as tloop

N, STEPS, EVERY = W.TOY_N, W.TOY_STEPS, W.TOY_RECORD
JAX_RUNS = {
    "wash_opt-adamw": ("adamw", dict(kind="wash_opt", base_p=0.5,
                                     mode="bucketed")),
    "papa": ("sgd", dict(kind="papa", papa_every=2, papa_alpha=0.9)),
    "none": ("sgd", dict(kind="none")),
}
PORT_RUNS = dict(W.ENGINE_RUNS, wash_opt=dict(kind="wash_opt", base_p=0.5,
                                              mode="bucketed"))


def _jax_loss(p, b):
    h = jnp.tanh(b["x"] @ p["embed"]["w"] @ p["blocks"][0]["w1"])
    return jnp.mean((h @ p["head"]["w"] - b["y"]) ** 2)


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_engine_at_world_one_tracks_the_jax_vmap_loop(name, monkeypatch):
    optimizer, mkw = JAX_RUNS[name]
    rng = np.random.default_rng(7)
    init = {k: rng.standard_normal(s, np.float32) for k, s in
            (("embed", (16, 8)), ("w1", (8, 8)), ("head", (8, 4)))}
    batches = {(m, s): (rng.standard_normal((4, 16), np.float32),
                        rng.standard_normal((4, 4), np.float32))
               for m in range(N) for s in range(STEPS)}
    lr = 3e-3 if optimizer == "adamw" else 0.05

    def jinit(k):
        return {"embed": {"w": jnp.asarray(init["embed"])},
                "blocks": [{"w1": jnp.asarray(init["w1"])}],
                "head": {"w": jnp.asarray(init["head"])}}

    key = jax.random.key(0)
    want = jloop.train_population(
        key, jinit, _jax_loss,
        lambda m, s, k: {"x": jnp.asarray(batches[m, s][0]),
                         "y": jnp.asarray(batches[m, s][1])},
        JaxTrainConfig(population=N, optimizer=optimizer, lr=lr,
                       total_steps=STEPS), jmix.MixingConfig(**mkw), 1,
        record_every=EVERY)

    # the plans JAX's loop drew, step by step, handed to the port
    drawn = []
    if mkw["kind"] == "wash_opt":
        jp = jpop.init_population(jinit, key, N)
        lids = jlids(jax.tree_util.tree_map(lambda x: x[0], jp), 1)
        base = jax.random.fold_in(key, 1234)
        plans = [jax.tree_util.tree_map(np.asarray, jshf.make_plan(
            step_key(base, s), jp, lids, jtotal(1), 0.5, "decreasing",
            "bucketed")) for s in range(STEPS)]

        def jax_plan(seed, params, *args, **kwargs):
            plan = plans[len(drawn)]
            drawn.append(seed)
            return pop.tree_map(
                lambda a: None if a is None else torch.from_numpy(a.copy()),
                plan, is_leaf=lambda x: x is None)

        monkeypatch.setattr(shf, "make_plan", jax_plan)
    got = tloop.train_population(
        0, lambda s: {"embed": {"w": torch.from_numpy(init["embed"])},
                      "blocks": [{"w1": torch.from_numpy(init["w1"])}],
                      "head": {"w": torch.from_numpy(init["head"])}},
        W.toy_loss,
        lambda m, s, seed: {"x": torch.from_numpy(batches[m, s][0]),
                            "y": torch.from_numpy(batches[m, s][1])},
        TrainConfig(population=N, optimizer=optimizer, lr=lr,
                    total_steps=STEPS), mix.MixingConfig(**mkw), 1,
        record_every=EVERY, engine="shard_map", device="cpu")

    assert len(drawn) == (STEPS if mkw["kind"] == "wash_opt" else 0)
    assert len(set(drawn)) == len(drawn)
    assert got.history["step"] == want.history["step"] == [0, 5, 10]
    assert got.comm_scalars == want.comm_scalars
    assert got.history["comm"] == want.history["comm"]
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.history["consensus"],
                               want.history["consensus"], rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(pop.tree_leaves(got.population),
                    jax.tree_util.tree_leaves(want.population)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert got.member_offset == 0
    assert set(got.phase_ms) == set(tloop.PHASES)
    assert all(len(v) == STEPS for v in got.phase_ms.values())


def _port_run(kw, engine_name, **opts):
    engine.reset_chunk_trace_count()
    tcfg = TrainConfig(population=N, optimizer="sgd", lr=0.05,
                       total_steps=STEPS, batch_size=4)
    return tloop.train_population(
        0, W.toy_init, W.toy_loss, W.toy_data, tcfg, mix.MixingConfig(**kw),
        1, record_every=EVERY, engine=engine_name, device="cpu",
        engine_opts=opts or None)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pop.tree_leaves(a),
                                                 pop.tree_leaves(b)))


@pytest.mark.parametrize("name", sorted(PORT_RUNS))
def test_engine_at_world_one_is_the_vmap_loop_bitwise(name):
    loop = _port_run(PORT_RUNS[name], "vmap")
    for opts in ({}, {"async_staging": True}, {"split_gate_runs": False}):
        got = _port_run(PORT_RUNS[name], "shard_map", **opts)
        assert _same(got.population, loop.population), opts
        assert _same(got.opt_state, loop.opt_state), opts
        for k in ("step", "loss", "consensus", "comm"):
            assert got.history[k] == loop.history[k], (opts, k)
        assert got.comm_scalars == loop.comm_scalars


@pytest.mark.parametrize("kw,split,built", [
    (dict(kind="wash", base_p=0.5, mode="bucketed"), True, 1),
    (dict(kind="wash", base_p=0.5, mode="bucketed"), False, 1),
    (dict(kind="none"), True, 1),
    (dict(kind="papa", papa_every=2), True, 2),
    (dict(kind="papa", papa_every=2), False, 2),
], ids=["wash", "wash-nosplit", "none", "papa-split", "papa-nosplit"])
def test_chunk_functions_built(kw, split, built):
    """One function a variant of the schedule.  Without the split a
    window that mixes anywhere runs on the mixing function, one chunk a
    record window; PAPA's first window (step 0, which never mixes) still
    runs collective-free, as in the reference's schedule."""
    res = _port_run(kw, "shard_map", split_gate_runs=split)
    assert engine.chunk_trace_count() == built
    sched = engine.build_schedule(STEPS, EVERY, mix.MixingConfig(**kw),
                                  split_gate_runs=split)
    assert len(sched.variants()) == built
    if not split:
        assert ([(c.start, c.stop) for c in sched.chunks]
                == engine.chunk_ranges(STEPS, EVERY))
    assert res.history["step"] == [0, 5, 10]


@pytest.fixture(scope="module")
def across_ranks(tmp_path_factory):
    wait = W.start("engine", 4, str(tmp_path_factory.mktemp("engine")), {})
    world1 = {name: W.toy_train(kw) for name, kw in W.ENGINE_RUNS}
    return world1, wait()[0]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [name for name, _ in W.ENGINE_RUNS])
def test_engine_across_ranks_equals_world_one(across_ranks, name, world):
    world1, got = across_ranks
    want = world1[name]
    for k, v in W.flat_tree(want.population).items():
        np.testing.assert_array_equal(got[f"{name}_{world}/{k}"], v.numpy())
    assert got[f"{name}_{world}/comm"].tolist() == want.history["comm"]
    assert got[f"{name}_{world}/step"].tolist() == want.history["step"]
    assert int(got[f"{name}_{world}/offset"]) == 0
    np.testing.assert_allclose(got[f"{name}_{world}/loss"],
                               want.history["loss"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[f"{name}_{world}/consensus"],
                               want.history["consensus"], rtol=1e-5,
                               atol=1e-6)


CLI = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
       "--population", "2", "--steps", "3", "--batch-size", "2",
       "--seq-len", "8"]


def _printed(out: str) -> list:
    keep = ("final mean member loss", "consensus distance",
            "scalars sent per member", "averaged-model loss")
    return [line for line in out.splitlines() if line.startswith(keep)]


def test_train_cli_engines_print_the_same_run(capsys):
    train_cli.main(CLI + ["--mode", "bucketed"])
    vmap = capsys.readouterr().out
    train_cli.main(CLI + ["--mode", "bucketed", "--engine", "shard_map",
                          "--sync-staging", "--record-every", "2"])
    sharded = capsys.readouterr().out
    assert len(_printed(vmap)) == 4
    assert _printed(sharded) == _printed(vmap)
    assert "engine=shard_map" in sharded and "mesh: ens=1" in sharded

    train_cli.main(CLI + ["--mode", "bucketed", "--engine", "shard_map",
                          "--mesh", "ens_dp_mp", "--record-every", "2"])
    multi = capsys.readouterr().out
    assert _printed(multi) == _printed(vmap)
    assert "mesh: {'ens': 1, 'data': 1, 'model': 1}" in multi

    train_cli.main(CLI + ["--engine", "shard_map", "--steps", "1"])
    out = capsys.readouterr().out
    assert "switching --mode dense -> bucketed" in out
    # two pipeline stages need two ranks after the ens axis
    with pytest.raises(ValueError, match="pp_stages=2 must divide"):
        train_cli.main(CLI + ["--engine", "shard_map", "--mesh", "ens_pp",
                              "--pp-stages", "2"])
    with pytest.raises(SystemExit):
        train_cli.main(CLI + ["--engine", "shard_map", "--pp-stages", "2"])
    with pytest.raises(SystemExit):
        train_cli.main(CLI + ["--sync-staging"])


def test_engine_telemetry_stream_passes_the_schema_checker(tmp_path):
    """The engine's stream (``train.stage`` and ``train.chunk_execute``
    spans, a ``train.comm_volume`` event a mixing chunk, the
    ``compile.train_chunk`` record of each chunk function built) replays
    under ``tools/check_metrics_schema.py --require-comm``."""
    import json

    from tools.check_metrics_schema import check_stream

    out = str(tmp_path / "engine.jsonl")
    res = train_cli.main(CLI + ["--mode", "bucketed", "--engine",
                                "shard_map", "--record-every", "2",
                                "--metrics-out", out])
    assert check_stream(out, require_comm=True) == []
    records = [json.loads(line) for line in open(out)]
    named = [r.get("name") for r in records]
    assert {"train.stage", "train.chunk_execute", "train.comm_volume",
            "train.record"} <= set(named)
    compiles = [r for r in records if r["kind"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["mixing"] is True
    comm = [r for r in records if r.get("name") == "train.comm_volume"]
    assert sum(r["mix_steps"] for r in comm) == 3
    assert comm[-1]["comm_total"] == res.comm_scalars


def _never(seed):
    raise AssertionError("a parameter was made")


def test_refusals_come_before_any_parameter(monkeypatch):
    tcfg = TrainConfig(population=4, total_steps=1)
    args = (0, _never, W.toy_loss, W.toy_data, tcfg)
    bucketed = mix.MixingConfig(kind="wash", mode="bucketed")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        tloop.train_population(*args, bucketed, 1, engine="shard_map",
                               device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        tloop.train_population(*args, bucketed, 1, engine="shard_map")
    with pytest.raises(ValueError, match="one card per rank"):
        tmesh.make_host_ensemble_mesh(2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="bucketed"):
        tloop.train_population(*args, mix.MixingConfig(kind="wash"), 1,
                               engine="shard_map", device="cpu")
    with pytest.raises(ValueError, match="multi-axis"):
        tloop.train_population(*args, bucketed, 1, engine="shard_map",
                               device="cpu", engine_opts={"param_specs": {}})
    with pytest.raises(ValueError, match="pp_stages=2 must divide"):
        tmesh.make_host_mesh(4, "ens_pp", pp_stages=2, device="cpu")
    with pytest.raises(ValueError, match="mesh="):
        tloop.train_population(*args, bucketed, 1, device="cpu",
                               mesh=tmesh.make_host_ensemble_mesh(4, "cpu"))
