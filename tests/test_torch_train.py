"""The port's training slice against the JAX package: loss and gradients,
the data, five steps of ``train_population``, and the train CLI, for
llama3.2-3b and rwkv6-3b (whose WKV recurrence the port differentiates
with ``ops.rwkv6_scan``'s backward, where JAX differentiates a
``lax.scan``).

Tolerances, each with its reason:
* ``loss_fn`` and its gradients on the reduced float32 llama3.2-3b and
  rwkv6-3b, JAX weights carried across: loss within 1e-5, gradients
  within 1e-4 (float32 matmuls, softmax sums and the WKV state in two
  frameworks).
* ``train_population``, 5 steps of N=3 members on JAX's batches (fed
  through ``data_fn``) and JAX's WASH plans (through a monkeypatched
  ``make_plan``), for every mixing kind on a llama-shaped config and for
  WASH (dense and bucketed) on the reduced rwkv6-3b: params within 1e-4
  and recorded
  losses within 1e-5 (float32 forward/backward/optimizer arithmetic in
  another order, compounded over 5 steps); the comm totals exactly equal
  (bucketed sizes in float64 from shapes); for dense WASH, exactly the
  float64 count of JAX's masks, and within 2**-22 of the reference's sum
  of float32-rounded per-step counts.
* The CLI's ``--ckpt-population`` file: read back by the port's serve CLI,
  and by JAX's ``checkpoint.restore`` bitwise (float32); for rwkv6, served
  by the scan engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import mixing as jmix
from repro.core import shuffle as jshf
from repro.core.layer_index import infer_layer_ids, total_layers
from repro.core.population import init_population as jinit_population
from repro.core.prng import step_key
from repro.models import transformer as JM
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import layer_index as tli
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.core.prng import fold_in
from repro_torch.data import make_lm_task, sample_tokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TM
from repro_torch.train import loop as tloop
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
N, STEPS, B, S = 3, 5, 2, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,variant", [
    ("llama3.2-3b", {}),
    ("llama3.2-3b", {"attn_impl": "chunked", "attn_chunk": 4}),
    ("llama3.2-3b", {"remat_blocks": True}),
    ("rwkv6-3b", {}),
    ("rwkv6-3b", {"remat_blocks": True}),
], ids=["naive", "chunked", "remat", "rwkv6", "rwkv6-remat"])
def test_loss_and_grads_match_jax(arch, variant):
    jcfg = jget_arch(arch).reduced(**variant)
    tcfg = get_arch(arch).reduced(**variant)
    jparams = JM.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (2, 16)).astype(np.int32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    tparams = params_from_numpy(_np(jparams), "cpu")
    leaves = [x.requires_grad_() for x in pop.tree_leaves(tparams)]
    tloss, aux = TM.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(aux["aux"]) == 0.0
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_rwkv6_training_runs_the_wkv_from_no_state(remat, monkeypatch):
    """Each layer's time mix starts from a zero state passed as None, so
    the WKV forward returns no final state and its backward writes no
    dstate0: the variant ``chip_smoke.py`` holds and times."""
    from repro_torch.kernels import ops

    states, scan = [], ops.rwkv6_scan

    def spy(*xs, state=None):
        states.append(state)
        return scan(*xs, state=state)

    monkeypatch.setattr(ops, "rwkv6_scan", spy)
    cfg = get_arch("rwkv6-3b").reduced(remat_blocks=remat)
    params = TM.init_params(cfg, seed=0, device="cpu")
    leaves = [x.requires_grad_() for x in pop.tree_leaves(params)]
    loss, _ = TM.loss_fn(params, cfg,
                         {"tokens": torch.zeros((1, 8), dtype=torch.int64)})
    torch.autograd.grad(loss, leaves)
    assert states == [None] * cfg.num_layers * (2 if remat else 1)


def test_chunked_attention_matches_naive():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    for window, bidir in ((None, False), (5, False), (None, True)):
        mask = (torch.ones(16, 16, dtype=torch.bool) if bidir
                else TL.causal_mask(16, window))
        torch.testing.assert_close(
            TL.sdpa_chunked(q, k, v, 2, chunk=4, window=window,
                            bidirectional=bidir),
            TL.sdpa(q, k, v, mask, 2), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="chunk"):
        TL.sdpa_chunked(q, k, v, 2, chunk=5)


def test_causal_mask_matches_jax():
    from repro.models import layers as JL
    for window in (None, 3):
        np.testing.assert_array_equal(TL.causal_mask(9, window).numpy(),
                                      np.asarray(JL.causal_mask(9, window)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_lm_task_is_a_deterministic_markov_chain():
    task = make_lm_task(3, vocab=16, device="cpu")
    assert task.table.shape == (16, 16) and task.vocab == 16
    assert torch.equal(task.table,
                       make_lm_task(3, vocab=16, device="cpu").table)
    a = sample_tokens(task, 7, 64, 200)
    assert a.shape == (64, 200) and int(a.min()) >= 0 and int(a.max()) < 16
    assert torch.equal(a, sample_tokens(task, 7, 64, 200))
    assert not torch.equal(a, sample_tokens(task, 8, 64, 200))
    # Gumbel-max draws each successor from softmax(table[previous token])
    prev, nxt = a[:, :-1].reshape(-1), a[:, 1:].reshape(-1)
    counts = torch.zeros(16, 16)
    counts.index_put_((prev, nxt), torch.ones(prev.numel()), accumulate=True)
    seen = counts.sum(1) > 400
    emp = counts[seen] / counts[seen].sum(1, keepdim=True)
    want = torch.softmax(task.table[seen], dim=1)
    assert float((emp - want).abs().max()) < 0.08
    # a few preferred successors per state, as the reference's table gives
    assert float(want.max(dim=1).values.mean()) > 0.5


def test_concrete_batch_for_attention_models():
    cfg = ModelConfig(**CFG_KW)
    b = concrete_batch(cfg, 4, 3, 7, device="cpu")
    assert set(b) == {"tokens"} and b["tokens"].shape == (3, 7)
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b["tokens"],
                       concrete_batch(cfg, 4, 3, 7, device="cpu")["tokens"])
    # the frontends' stubbed inputs: frames or patches of (B, n, d_model)
    # in the config's dtype, the same for the same seed, the tokens as
    # without a frontend
    for arch, key, n in (("whisper-medium", "frames", "num_frames"),
                         ("internvl2-76b", "patches", "num_patches")):
        mcfg = get_arch(arch).reduced()
        b = concrete_batch(mcfg, 4, 3, 7, device="cpu")
        assert set(b) == {"tokens", key}
        assert b[key].shape == (3, getattr(mcfg, n), mcfg.d_model)
        assert b[key].dtype == torch.float32 and b[key].std() > 0.5
        again = concrete_batch(mcfg, 4, 3, 7, device="cpu")
        assert all(torch.equal(b[k], again[k]) for k in b)
        assert not torch.equal(
            b[key], concrete_batch(mcfg, 5, 3, 7, device="cpu")[key])
        assert concrete_batch(dataclasses.replace(mcfg, dtype="bfloat16"), 4,
                              3, 7, device="cpu")[key].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# five steps of train_population against JAX's vmap loop
# ---------------------------------------------------------------------------

RUNS = [("wash", "dense", "sgd"), ("wash", "bucketed", "sgd"),
        ("wash_opt", "bucketed", "adamw"), ("wash_opt", "dense", "sgd"),
        ("papa", "dense", "sgd"), ("papa_all", "dense", "sgd"),
        ("none", "dense", "sgd")]
# the reduced rwkv6-3b: its nested ``blocks.rwkv.tm.*`` / ``cm.*`` leaves
# and float32 ``w0`` / ``u`` through the layer depths and the plans
RWKV_RUNS = [("wash", "dense", "sgd"), ("wash", "bucketed", "sgd")]


def _configs_of(arch):
    if arch == "rwkv6-3b":
        return jget_arch(arch).reduced(), get_arch(arch).reduced()
    return JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)


@pytest.mark.parametrize(
    "arch,kind,mode,optimizer",
    [("llama", *run) for run in RUNS]
    + [("rwkv6-3b", *run) for run in RWKV_RUNS],
    ids=["-".join(run) for run in RUNS]
    + ["rwkv6-" + "-".join(run) for run in RWKV_RUNS])
def test_train_population_tracks_jax_loop(arch, kind, mode, optimizer,
                                          monkeypatch):
    jcfg, tcfg = _configs_of(arch)
    rng = np.random.default_rng(11)
    batches = {(m, s): rng.integers(0, 50, (B, S)).astype(np.int32)
               for m in range(N) for s in range(STEPS)}
    key = jax.random.key(0)
    lr = 3e-3 if optimizer == "adamw" else 0.05
    mkw = dict(kind=kind, base_p=0.3, mode=mode, papa_every=2,
               papa_all_every=3)
    jtc = JaxTrainConfig(population=N, optimizer=optimizer, lr=lr,
                         total_steps=STEPS)
    ttc = TrainConfig(population=N, optimizer=optimizer, lr=lr,
                      total_steps=STEPS)

    def jinit(k):
        return JM.init_params(k, jcfg)

    want = jloop.train_population(
        key, jinit, lambda p, b: JM.loss_fn(p, jcfg, b)[0],
        lambda m, s, k: {"tokens": jnp.asarray(batches[m, s])},
        jtc, jmix.MixingConfig(**mkw), jcfg.num_layers, record_every=1)

    # the plans JAX's loop drew, step by step, handed to the port
    jpop = jinit_population(jinit, key, N)
    lids = infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpop), 2)
    base = jax.random.fold_in(key, 1234)
    plans = [jshf.make_plan(step_key(base, s), jpop, lids, total_layers(2),
                            0.3, "decreasing", mode) for s in range(STEPS)]
    drawn = []

    def jax_plan(seed, params, *args, **kwargs):
        plan = plans[len(drawn)]
        drawn.append(seed)
        return pop.tree_map(
            lambda a: None if a is None else torch.from_numpy(a),
            jax.tree_util.tree_map(np.array, plan))

    monkeypatch.setattr(shf, "make_plan", jax_plan)
    init = params_from_numpy(_np(jinit(key)), "cpu")
    got = tloop.train_population(
        0, lambda s: pop.tree_map(torch.clone, init),
        lambda p, b: TM.loss_fn(p, tcfg, b)[0],
        lambda m, s, seed: {"tokens": torch.from_numpy(batches[m, s])},
        ttc, mix.MixingConfig(**mkw), tcfg.num_layers, record_every=1,
        device="cpu")

    assert len(drawn) == (STEPS if kind in ("wash", "wash_opt") else 0)
    assert len(set(drawn)) == len(drawn)  # one seed per step
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.history["consensus"],
                               want.history["consensus"], rtol=1e-4, atol=1e-5)
    if mode == "dense" and kind in ("wash", "wash_opt"):
        # exact float64 counts of the same masks; the reference adds
        # float32-rounded per-step counts (2**-23 relative each)
        moments = 2 if optimizer == "adamw" else 1  # mu (and nu) replay it
        reps = 1 + moments if kind == "wash_opt" else 1
        sent = [reps * int(jshf.plan_selected_scalars(p, mode)) * (N - 1) / N
                for p in plans]
        assert got.history["comm"] == list(np.cumsum(sent))
        np.testing.assert_allclose(got.history["comm"], want.history["comm"],
                                   rtol=2 ** -22)
    else:
        assert got.comm_scalars == want.comm_scalars
        assert got.history["comm"] == want.history["comm"]
    assert got.history["step"] == want.history["step"]
    for g, w in zip(pop.tree_leaves(got.population),
                    jax.tree_util.tree_leaves(want.population)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert got.opt_state["step"].tolist() == [STEPS] * N
    assert set(got.phase_ms) == set(tloop.PHASES)
    assert all(len(v) == STEPS for v in got.phase_ms.values())


def test_train_population_refuses_what_it_does_not_run():
    cfg = ModelConfig(**CFG_KW)
    args = (0, lambda s: TM.init_params(cfg, seed=s, device="cpu"),
            lambda p, b: TM.loss_fn(p, cfg, b)[0], None,
            TrainConfig(population=2, total_steps=1), mix.MixingConfig(), 2)
    with pytest.raises(ValueError, match="multi-axis"):
        tloop.train_population(*args[:5], mix.MixingConfig(mode="bucketed"),
                               2, engine="shard_map", device="cpu",
                               engine_opts={"param_specs": {}})
    with pytest.raises(ValueError, match="engine"):
        tloop.train_population(*args, engine="pmap", device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tloop.train_population(0, lambda s: TM.param_shapes(cfg), *args[2:],
                               device="cpu")


def test_train_population_holds_applied_plans_to_the_static_comm(monkeypatch):
    """The loop records the comm worked out from shapes, and raises when
    the plans that mix_once applied sent another count."""
    cfg = ModelConfig(**CFG_KW)
    task = make_lm_task(0, vocab=50, device="cpu")
    args = (0, lambda s: TM.init_params(cfg, seed=s, device="cpu"),
            lambda p, b: TM.loss_fn(p, cfg, b)[0],
            lambda m, step, s: {"tokens": sample_tokens(task, s, B, S)},
            TrainConfig(population=N, total_steps=2),
            mix.MixingConfig(kind="wash", base_p=0.3, mode="bucketed"), 2)
    res = tloop.train_population(*args, record_every=1, device="cpu")
    static = mix.static_mix_comm(TM.param_shapes(cfg), args[5],
                                 tli.infer_layer_ids(TM.param_shapes(cfg), 2),
                                 tli.total_layers(2), N)
    assert res.history["comm"] == [static, 2 * static]
    sent = shf.plan_sent_scalars
    monkeypatch.setattr(shf, "plan_sent_scalars",
                        lambda plan, n, mode: sent(plan, n, mode) + 1.0)
    with pytest.raises(RuntimeError, match="applied plans sent"):
        tloop.train_population(*args, device="cpu")


# ---------------------------------------------------------------------------
# the CLI, and its population file read back by both packages
# ---------------------------------------------------------------------------


def test_train_cli_round_trip_to_serve_and_jax(tmp_path, capsys):
    ckpt = str(tmp_path / "pop.npz")
    hist = str(tmp_path / "hist.json")
    res = ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                       "--population", "2", "--mode", "bucketed", "--steps",
                       "3", "--batch-size", "2", "--seq-len", "8",
                       "--ckpt-population", ckpt, "--history", hist,
                       "--ckpt", str(tmp_path / "soup.npz")])
    out = capsys.readouterr().out
    for label in ("arch=llama3.2-3b-reduced mixing=wash steps=3 engine=vmap",
                  "final mean member loss :", "consensus distance     :",
                  "scalars sent per member:", "averaged-model loss    :",
                  "saved averaged model ->", "saved population ->",
                  "trained tokens/s       :"):
        assert label in out, label
    assert np.isfinite(res.history["loss"]).all()
    shapes = TM.param_shapes(get_arch("llama3.2-3b").reduced())
    assert res.comm_scalars == 3 * mix.static_mix_comm(
        shapes, mix.MixingConfig(kind="wash", base_p=0.01, mode="bucketed"),
        tli.infer_layer_ids(shapes, 2), 4, 2)

    # JAX reads the file (float32 leaves) into its own population template
    jcfg = jget_arch("llama3.2-3b").reduced()
    like = jax.eval_shape(lambda: jinit_population(
        lambda k: JM.init_params(k, jcfg), jax.random.key(0), 2))
    restored = jckpt.restore(ckpt, like)
    for g, w in zip(pop.tree_leaves(res.population),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    tserve.main(["--arch", "llama3.2-3b", "--reduced", "--continuous",
                 "--device", "cpu", "--population", "2", "--ckpt", ckpt,
                 "--requests", "3", "--max-new", "3", "--seq-len", "8"])
    out = capsys.readouterr().out
    assert f"restored population <- {ckpt}" in out
    assert "continuous mode=soup requests=3" in out


def test_train_cli_rwkv6_round_trip_to_the_scan_engine(tmp_path, capsys):
    """rwkv6 trains through the CLI on the CPU (the plain WKV backward);
    its population file restores in JAX bitwise and serves through the
    serve CLI's scan engine, as the trained population does in memory."""
    from repro_torch.serving import engine

    ckpt = str(tmp_path / "pop.npz")
    res = ttrain.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                       "--population", "2", "--mode", "bucketed", "--steps",
                       "2", "--batch-size", "2", "--seq-len", "8",
                       "--record-every", "1", "--ckpt-population", ckpt])
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b-reduced mixing=wash steps=2 engine=vmap" in out
    assert np.isfinite(res.history["loss"]).all()
    cfg = get_arch("rwkv6-3b").reduced()
    shapes = TM.param_shapes(cfg)
    assert res.history["comm"] == [k * mix.static_mix_comm(
        shapes, mix.MixingConfig(kind="wash", base_p=0.01, mode="bucketed"),
        tli.infer_layer_ids(shapes, 2), 4, 2) for k in (1, 2)]

    jcfg = jget_arch("rwkv6-3b").reduced()
    like = jax.eval_shape(lambda: jinit_population(
        lambda k: JM.init_params(k, jcfg), jax.random.key(0), 2))
    for g, w in zip(pop.tree_leaves(res.population),
                    jax.tree_util.tree_leaves(jckpt.restore(ckpt, like))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    outs = tserve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                        "--population", "2", "--ckpt", ckpt, "--batch-size",
                        "2", "--seq-len", "8", "--max-new", "4"])
    assert f"restored population <- {ckpt}" in capsys.readouterr().out
    batch = concrete_batch(cfg, fold_in(0, 2), 2, 8, device="cpu")
    want = engine.generate(engine.serving_params(res.population, "soup"),
                           cfg, batch, 4, device="cpu")
    assert torch.equal(outs["soup"]["tokens"], want)


def test_init_population_and_map_members_match_jax():
    from repro.core.population import map_members as jmap_members
    from repro_torch.core.prng import fold_in

    seeds = []

    def init(seed):
        seeds.append(seed)
        return {"w": torch.arange(4.0) * (seed % 7 + 1)}

    same = pop.init_population(init, 5, 3)
    assert seeds == [5] and same["w"].shape == (3, 4)
    assert torch.equal(same["w"][0], same["w"][2])
    seeds.clear()
    apart = pop.init_population(init, 5, 3, same_init=False)
    assert seeds == [fold_in(5, i) for i in range(3)] and len(set(seeds)) == 3

    def fn(p, scale):
        return {"s": (p["w"] * scale).sum(), "w2": p["w"] * p["w"]}

    scales = np.array([1.0, -2.0, 0.5], np.float32)
    got = pop.map_members(fn, apart, torch.from_numpy(scales))
    want = jmap_members(lambda p, s: {"s": (p["w"] * s).sum(),
                                      "w2": p["w"] * p["w"]},
                        {"w": jnp.asarray(apart["w"].numpy())},
                        jnp.asarray(scales))
    for (_, g), w in zip(pop.tree_paths(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
