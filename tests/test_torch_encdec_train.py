"""Three steps of bucketed WASH training in the port against the JAX
package's vmap loop, on the CPU, for the reduced whisper-medium (the
encoder's ``enc_blocks.*``, the decoder's ``xattn.*`` and ``ln_x``, the
frame projection and ``enc_pos`` through the layer depths, the plans and
the backward) and the reduced deepseek-v2-lite-16b (MLA's plain training
attention and the MoE router's aux loss).  Both loops start from the
port's weights, take the same numpy batches (frames included) and apply
one set of WASH plans: the port planner's (its plans' shapes and sizes
are held to JAX's ``make_plan`` in ``tests/test_torch_shuffle.py``),
drawn on the host for each key JAX's jitted mixing step passes to a
monkeypatched ``make_plan`` (a ``jax.pure_callback``) and replayed, in
order, through the port's monkeypatched ``make_plan``.  Compiling JAX's
planner, or its initializer, for every leaf and layer would take most
of this file's time.

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
from repro.models import transformer as JM
from repro.train import loop as jloop
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import layer_index as tli
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.models import transformer as TM
from repro_torch.train import loop as tloop
from repro_torch.train.interop import params_to_numpy

STEPS, N = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["whisper-medium", "deepseek-v2-lite-16b"])
def test_wash_training_tracks_the_jax_loop(arch, monkeypatch):
    """Three steps of bucketed WASH (SGD, N=2) on the reduced config,
    both loops on the same weights, batches and plans: params within
    1e-4, losses within 1e-5, the comm exactly equal (each loop counts
    its planner's static sizes, and the port's holds the plans it applies
    to them)."""
    jcfg, tcfg = (jax_arch(arch).reduced(d_model=64),
                  get_arch(arch).reduced(d_model=64))
    rng = np.random.default_rng(12)
    batches = {}
    for m in range(N):
        for s in range(STEPS):
            b = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 8))
                 .astype(np.int32)}
            if jcfg.is_encdec:
                b["frames"] = rng.standard_normal(
                    (2, jcfg.num_frames, jcfg.d_model)).astype(np.float32)
            batches[m, s] = b
    # the port's weights, handed to JAX's loop as data (every member
    # starts from them, as WASH does); its step keys only pick the plans
    init = TM.init_params(tcfg, seed=0, device="cpu")
    weights = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(init))
    key = jax.random.key(0)
    mkw = dict(kind="wash", base_p=0.3, mode="bucketed")
    shapes = TM.param_shapes(tcfg)
    lids = tli.infer_layer_ids(shapes, tcfg.num_layers)

    def port_plan(key_data):
        """The port's plan for one of JAX's step keys (the same plan for
        the same key), as int32 numpy."""
        seed = int.from_bytes(np.asarray(key_data).tobytes(), "little")
        plan = shf.make_plan(seed % 2**31, shapes, lids,
                             tli.total_layers(tcfg.num_layers), mkw["base_p"],
                             mode=mkw["mode"], n=N, device="cpu")
        return pop.tree_map(
            lambda a: None if a is None else a.numpy().astype(np.int32), plan)

    plans = []
    plan_shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), port_plan([0, 0]))

    def host_plan(key, *args, **kwargs):
        """Inside JAX's jitted mixing step: the port's plan for ``key``,
        drawn on the host and kept in the order JAX applies them."""
        def draw(key_data):
            plans.append(port_plan(key_data))
            return plans[-1]

        return jax.pure_callback(draw, plan_shapes,
                                 jax.random.key_data(key))

    monkeypatch.setattr(jshf, "make_plan", host_plan)
    want = jloop.train_population(
        key, lambda k: weights, lambda p, b: JM.loss_fn(p, jcfg, b)[0],
        lambda m, s, k: {n: jnp.asarray(v) for n, v in batches[m, s].items()},
        JaxTrainConfig(population=N, lr=0.05, total_steps=STEPS),
        jmix.MixingConfig(**mkw), jcfg.num_layers, record_every=1)
    assert len(plans) == STEPS
    assert len({b"".join(a.tobytes() for a in jax.tree_util.tree_leaves(p))
                for p in plans}) == STEPS  # a new key, a new plan, each step
    drawn = []

    def replay_plan(seed, params, *args, **kwargs):
        plan = plans[len(drawn)]
        drawn.append(seed)
        return pop.tree_map(
            lambda a: None if a is None else torch.from_numpy(a), plan)

    monkeypatch.setattr(shf, "make_plan", replay_plan)
    got = tloop.train_population(
        0, lambda s: pop.tree_map(torch.clone, init),
        lambda p, b: TM.loss_fn(p, tcfg, b)[0],
        lambda m, s, seed: {n: torch.from_numpy(v)
                            for n, v in batches[m, s].items()},
        TrainConfig(population=N, lr=0.05, total_steps=STEPS),
        mix.MixingConfig(**mkw), tcfg.num_layers, record_every=1,
        device="cpu")
    assert len(drawn) == STEPS
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    assert got.history["comm"] == want.history["comm"]
    assert got.history["comm"][-1] > 0
    for (path, g), w in zip(pop.tree_paths(got.population),
                            jax.tree_util.tree_leaves(want.population)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=str(path), rtol=1e-4, atol=1e-4)
