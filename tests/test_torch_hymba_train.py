"""Three steps of bucketed WASH training of the reduced hymba-1.5b in the
port against the JAX package's vmap loop, on the CPU: JAX's weights,
batches and WASH plans handed to the port (the plans through a
monkeypatched ``make_plan``), so the hybrid tree's leaves (``mamba.*``,
``beta``, float32 ``A_log`` and ``D``) go through the layer depths, the
plans and the selective scan's backward (the plain reverse recurrence on
the CPU).

Tolerances, each with its reason: params within 1e-4 (float32 forward,
backward and SGD arithmetic in another order, compounded over the
steps); recorded losses within 1e-5; the comm exactly equal (bucketed
sizes in float64 from shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import mixing as jmix
from repro.core import shuffle as jshf
from repro.core.layer_index import infer_layer_ids, total_layers
from repro.core.population import init_population as jinit_population
from repro.core.prng import step_key
from repro.models import transformer as JM
from repro.train import loop as jloop
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.models import transformer as TM
from repro_torch.train import loop as tloop
from repro_torch.train.interop import params_from_numpy

ARCH = "hymba-1.5b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

STEPS, N = 3, 2


def test_wash_training_tracks_the_jax_loop(monkeypatch):
    """Three steps of bucketed WASH (SGD, N=2) on the reduced hymba, JAX's
    batches and plans handed to the port: params within 1e-4, losses
    within 1e-5, the comm exactly equal."""
    jcfg = jax_arch(ARCH).reduced(d_model=64)
    tcfg = get_arch(ARCH).reduced(d_model=64)
    rng = np.random.default_rng(11)
    batches = {(m, s): rng.integers(0, jcfg.vocab_size, (2, 8))
               .astype(np.int32) for m in range(N) for s in range(STEPS)}
    key = jax.random.key(0)
    mkw = dict(kind="wash", base_p=0.3, mode="bucketed")

    def jinit(k):
        return JM.init_params(k, jcfg)

    want = jloop.train_population(
        key, jinit, lambda p, b: JM.loss_fn(p, jcfg, b)[0],
        lambda m, s, k: {"tokens": jnp.asarray(batches[m, s])},
        JaxTrainConfig(population=N, lr=0.05, total_steps=STEPS),
        jmix.MixingConfig(**mkw), jcfg.num_layers, record_every=1)
    jpop = jinit_population(jinit, key, N)
    lids = infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpop),
                           jcfg.num_layers)
    base = jax.random.fold_in(key, 1234)
    plans = [jshf.make_plan(step_key(base, s), jpop, lids,
                            total_layers(jcfg.num_layers), 0.3, "decreasing",
                            "bucketed") for s in range(STEPS)]
    drawn = []

    def jax_plan(seed, params, *args, **kwargs):
        plan = plans[len(drawn)]
        drawn.append(seed)
        return pop.tree_map(
            lambda a: None if a is None else torch.from_numpy(a),
            jax.tree_util.tree_map(np.array, plan))

    monkeypatch.setattr(shf, "make_plan", jax_plan)
    init = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jinit(key)), "cpu")
    got = tloop.train_population(
        0, lambda s: pop.tree_map(torch.clone, init),
        lambda p, b: TM.loss_fn(p, tcfg, b)[0],
        lambda m, s, seed: {"tokens": torch.from_numpy(batches[m, s])},
        TrainConfig(population=N, lr=0.05, total_steps=STEPS),
        mix.MixingConfig(**mkw), tcfg.num_layers, record_every=1,
        device="cpu")
    assert len(drawn) == STEPS
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    assert got.history["comm"] == want.history["comm"]
    for (path, g), w in zip(pop.tree_paths(got.population),
                            jax.tree_util.tree_leaves(want.population)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=str(path), rtol=1e-4, atol=1e-4)

