"""The image-classification slice as a whole, on the CPU: classifier
populations through the port's ``train_population`` against JAX's vmap
loop, the paper's pattern (``tests/test_system.py``) on the port's own
generators, and ``launch.quickstart``.

Tolerances, each with its reason:
* five steps of N=3 members on JAX's batches (fed through ``data_fn``)
  and JAX's WASH plans (through a monkeypatched ``make_plan``), a small
  resnet under every mixing kind and the mlp under dense and bucketed
  WASH: params within 1e-4 and recorded losses within 1e-5 (float32
  forward / backward / optimizer arithmetic in another order, compounded
  over 5 steps); consensus within 1e-4; comm totals as
  ``tests/test_torch_train.py`` holds them (bucketed and PAPA exactly
  equal; dense WASH exactly the float64 count of JAX's masks).
* the pattern: the thresholds of ``tests/test_system.py``, unchanged, at
  its configuration and step counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import mixing as jmix
from repro.core import shuffle as jshf
from repro.core.layer_index import infer_layer_ids, total_layers
from repro.core.population import init_population as jinit_population
from repro.core.prng import step_key
from repro.data import augment as JAUG
from repro.data import synthetic as JSYN
from repro.models import cnn as JC
from repro.train import loop as jloop
from repro_torch.configs.base import TrainConfig
from repro_torch.core import averaging as avg
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.core.prng import fold_in
from repro_torch.data import (apply_policy, eval_images, make_image_task,
                              member_policies, sample_images,
                              soft_cross_entropy)
from repro_torch.launch import quickstart
from repro_torch.models import cnn as TC
from repro_torch.train import loop as tloop
from repro_torch.train.interop import params_from_numpy

N, STEPS, BATCH = 3, 5, 8
MODELS = {"resnet": dict(kind="resnet", width=4, depth=2, image_hw=6),
          "mlp": dict(kind="mlp", width=16, depth=2, image_hw=6)}
RUNS = [("wash", "dense", "sgd"), ("wash", "bucketed", "sgd"),
        ("wash_opt", "bucketed", "adamw"), ("wash_opt", "dense", "sgd"),
        ("papa", "dense", "sgd"), ("papa_all", "dense", "sgd"),
        ("none", "dense", "sgd")]
CASES = ([("resnet",) + run for run in RUNS]
         + [("mlp",) + run for run in RUNS[:2]])


@functools.lru_cache(maxsize=None)
def _jax_batches(hw):
    """Heterogeneous batches of ``hw`` x ``hw`` images from JAX's own
    pipeline: the image task, each member's policy, every (member, step)
    its own key."""
    key = jax.random.key(9)
    task = JSYN.make_image_task(key, 10, hw, noise=1.0)
    pols = JAUG.member_policies(jax.random.fold_in(key, 7), N, True)
    out = {}
    for m in range(N):
        for s in range(STEPS):
            k = jax.random.fold_in(jax.random.fold_in(key, s), m)
            x, y = JSYN.sample_images(task, k, BATCH)
            x, y = JAUG.apply_policy(jax.random.fold_in(k, 1), x, y, 10,
                                     pols[m])
            out[m, s] = (np.array(x), np.array(y))
    return out


@pytest.mark.parametrize("model,kind,mode,optimizer", CASES,
                         ids=["-".join(c) for c in CASES])
def test_train_population_tracks_jax_loop(model, kind, mode, optimizer,
                                          monkeypatch):
    jcfg, tcfg = JC.ClassifierConfig(**MODELS[model]), TC.ClassifierConfig(
        **MODELS[model])
    batches = _jax_batches(jcfg.image_hw)
    key = jax.random.key(0)
    lr = 3e-3 if optimizer == "adamw" else 0.05
    mkw = dict(kind=kind, base_p=0.3, mode=mode, papa_every=2,
               papa_all_every=3)
    jtc = JaxTrainConfig(population=N, optimizer=optimizer, lr=lr,
                         total_steps=STEPS)
    ttc = TrainConfig(population=N, optimizer=optimizer, lr=lr,
                      total_steps=STEPS)

    def jinit(k):
        return JC.init_classifier(k, jcfg)

    def jloss(p, b):
        return JAUG.soft_cross_entropy(JC.apply_classifier(p, jcfg, b["x"]),
                                       b["y"])

    want = jloop.train_population(
        key, jinit, jloss,
        lambda m, s, k: {"x": jnp.asarray(batches[m, s][0]),
                         "y": jnp.asarray(batches[m, s][1])},
        jtc, jmix.MixingConfig(**mkw), jcfg.num_blocks, record_every=1)

    # the plans JAX's loop drew, step by step, handed to the port
    jpop = jinit_population(jinit, key, N)
    nb = jcfg.num_blocks
    lids = infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpop), nb)
    base = jax.random.fold_in(key, 1234)
    plans = [jshf.make_plan(step_key(base, s), jpop, lids, total_layers(nb),
                            0.3, "decreasing", mode) for s in range(STEPS)]
    drawn = []

    def jax_plan(seed, params, *args, **kwargs):
        plan = plans[len(drawn)]
        drawn.append(seed)
        return pop.tree_map(
            lambda a: None if a is None else torch.from_numpy(a),
            jax.tree_util.tree_map(np.array, plan))

    monkeypatch.setattr(shf, "make_plan", jax_plan)
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jinit(key)),
                             "cpu")
    got = tloop.train_population(
        0, lambda s: pop.tree_map(torch.clone, init),
        lambda p, b: soft_cross_entropy(TC.apply_classifier(p, tcfg, b["x"]),
                                        b["y"]),
        lambda m, s, seed: {"x": torch.from_numpy(batches[m, s][0]),
                            "y": torch.from_numpy(batches[m, s][1])},
        ttc, mix.MixingConfig(**mkw), tcfg.num_blocks, record_every=1,
        device="cpu")

    assert len(drawn) == (STEPS if kind in ("wash", "wash_opt") else 0)
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.history["consensus"],
                               want.history["consensus"], rtol=1e-4, atol=1e-5)
    if mode == "dense" and kind in ("wash", "wash_opt"):
        moments = 2 if optimizer == "adamw" else 1
        reps = 1 + moments if kind == "wash_opt" else 1
        sent = [reps * int(jshf.plan_selected_scalars(p, mode)) * (N - 1) / N
                for p in plans]
        assert got.history["comm"] == list(np.cumsum(sent))
        np.testing.assert_allclose(got.history["comm"], want.history["comm"],
                                   rtol=2 ** -22)
    else:
        assert got.comm_scalars == want.comm_scalars
        assert got.history["comm"] == want.history["comm"]
    for g, w in zip(pop.tree_leaves(got.population),
                    jax.tree_util.tree_leaves(want.population)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the paper's pattern (tests/test_system.py) on the port's own generators
# ---------------------------------------------------------------------------

SEED = 42


def _setup(noise=1.4):
    task = make_image_task(SEED, num_classes=10, hw=10, noise=noise,
                           device="cpu")
    ccfg = TC.ClassifierConfig(kind="mlp", width=48, depth=2, num_classes=10,
                               image_hw=10)
    pols = member_policies(fold_in(SEED, 7), 3, heterogeneous=True)

    def data_fn(m, step, s):
        imgs, labels = sample_images(task, s, 48)
        x, y = apply_policy(fold_in(s, 1), imgs, labels, 10, pols[m])
        return {"x": x, "y": y}

    def loss_fn(params, batch):
        return soft_cross_entropy(TC.apply_classifier(params, ccfg, batch["x"]),
                                  batch["y"])

    ex, ey = eval_images(task, fold_in(SEED, 99), 256)
    return ccfg, data_fn, loss_fn, ex, ey


def _train(mcfg, ccfg, data_fn, loss_fn, steps=150):
    tcfg = TrainConfig(population=3, optimizer="sgd", lr=0.08,
                       total_steps=steps, batch_size=48)
    return tloop.train_population(
        SEED, lambda s: TC.init_classifier(s, ccfg, device="cpu"), loss_fn,
        data_fn, tcfg, mcfg, ccfg.num_blocks, record_every=50, device="cpu")


def test_wash_average_close_to_ensemble_and_cheaper_than_papa():
    ccfg, data_fn, loss_fn, ex, ey = _setup()
    apply_fn = lambda p, x: TC.apply_classifier(p, ccfg, x)
    wash = _train(mix.MixingConfig(kind="wash", base_p=0.05, mode="dense"),
                  ccfg, data_fn, loss_fn)
    papa = _train(mix.MixingConfig(kind="papa", papa_every=10,
                                   papa_alpha=0.99), ccfg, data_fn, loss_fn)
    ens = float(avg.ensemble_accuracy(apply_fn, wash.population, ex, ey))
    soup = float(avg.model_accuracy(apply_fn, avg.uniform_soup(wash.population),
                                    ex, ey))
    assert ens > 0.5, "population failed to learn"
    assert soup > ens - 0.08, (soup, ens)
    assert wash.comm_scalars < 0.5 * papa.comm_scalars, (
        wash.comm_scalars, papa.comm_scalars)


def test_wash_consensus_distance_below_baseline():
    ccfg, data_fn, loss_fn, _, _ = _setup()
    base = _train(mix.MixingConfig(kind="none"), ccfg, data_fn, loss_fn,
                  steps=120)
    wash = _train(mix.MixingConfig(kind="wash", base_p=0.05, mode="dense"),
                  ccfg, data_fn, loss_fn, steps=120)
    assert wash.history["consensus"][-1] < base.history["consensus"][-1]


def test_quickstart_runs_and_prints_its_table(capsys):
    rows = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "training two populations (baseline vs WASH)..." in out
    assert "method      Ensemble  Averaged  comm/member" in out
    assert [r["method"] for r in rows] == ["baseline", "wash"]
    for r in rows:
        assert (f"{r['method']:10s} {r['ensemble']:9.3f} {r['averaged']:9.3f} "
                f"{r['comm']:12.3e}") in out
    base, wash = rows
    assert base["comm"] == 0.0 and wash["comm"] > 0.0
    # the quickstart's claim, as the card's run checks it
    assert wash["ensemble"] > 0.5
    assert wash["averaged"] >= wash["ensemble"] - 0.08
    assert wash["consensus"] < base["consensus"]
