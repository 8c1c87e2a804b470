"""The ensemble engine on ens×data×model meshes of 4 ``gloo`` ranks.

One spawn of 4 ranks (``tests/torch_ring_worker.py``'s ``multiaxis``
scenario, a ``FileStore`` under ``tmp_path``, one 120 s deadline) trains
the multi-axis toy model (``tests/test_shardplan.py``'s ``MEMBER``
shapes; embed and blocks split over the model axis, the head replicated)
on the meshes of ``MX_RUNS``; here, in the parent, the port's engine
trains it at world 1 (already held to JAX's vmap loop) and JAX's planner
gives the comm:

  * ``none``, PAPA and PAPA-all bitwise equal to world 1 on (2,1,2) with
    N = 2 and 4, (1,1,4) with N = 2 (members split: gather, grad, slice),
    and (2,2,1) with N = 4 (the data axis joins the population), the
    population gathered on rank 0;
  * WASH and WASH+Opt on split members (one step): the replicated leaf
    bitwise, each split leaf (and its AdamW first moment) the same
    multiset per coordinate across members, and moved otherwise than at
    world 1; each rank's shard plans equal their reproduction here from
    ``fold_in(leaf_seed, position)``, and differ across model
    coordinates;
  * (2,2,1) with N = 2, batches split over the data axis: within rtol
    2e-5, atol 1e-6 of world 1 (a mean of means), the reference's bound;
  * on every mesh, the comm equals JAX's ``static_shard_mix_comm`` a
    mixing step exactly and at most 2 chunk functions are built;
  * a gathered population round-trips through ``checkpoint`` bitwise, and
    the train CLI on (2,1,2) writes world 1's ``--ckpt-population`` file
    bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core import shardplan as jsp
from repro.core.layer_index import infer_layer_ids as jlids
from repro.core.mixing import MixingConfig as JMixingConfig

import torch_ring_worker as W
from repro_torch.core import shardplan as sp
from repro_torch.core import shuffle as shf
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig, mixing_due
from repro_torch.core.prng import fold_in, leaf_seed
from repro_torch.launch import train as train_cli

AXES = ("ens", "data", "model")
RUNS = {tag: run for tag, *run in W.MX_RUNS}
ELEMENTWISE = [t for t, (_, _, kw, *_) in RUNS.items()
               if kw["kind"] in ("none", "papa", "papa_all")]
SPLIT_WASH = [t for t, (shape, _, kw, *_) in RUNS.items()
              if kw["kind"] in ("wash", "wash_opt") and shape[2] > 1]
JMEMBER = {"embed": {"w": jax.ShapeDtypeStruct((32, 16), jnp.float32)},
           "blocks": {"w1": jax.ShapeDtypeStruct((2, 16, 64), jnp.float32)},
           "head": {"w": jax.ShapeDtypeStruct((16, 8), jnp.float32)}}
JSPECS = {"embed": {"w": JP(None, "model")},
          "blocks": {"w1": JP(None, None, "model")},
          "head": {"w": JP()}}
# leaf order (embed, blocks, head) and which leaves the model axis splits
LEAVES = ("embed/w", "blocks/w1", "head/w")
SPLIT = {"embed/w": True, "blocks/w1": True, "head/w": False}


def fake_mesh(shape):
    return types.SimpleNamespace(axis_names=AXES,
                                 shape=dict(zip(AXES, shape)))


def jax_comm(shape, n, kw, optimizer) -> float:
    """JAX's exact scalars a member sends a mixing step on ``shape``."""
    pplan = jsp.plan_population_mixing(
        fake_mesh(shape), JMEMBER, JSPECS, JMixingConfig(**kw),
        jlids(JMEMBER, 2), 4, n)
    opt = ({"mu": 0, "nu": 0, "step": 0} if optimizer == "adamw"
           else {"mu": 0, "step": 0})
    return jsp.static_shard_mix_comm(pplan, opt_state=opt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' results, world 1's and the CLI's files (world 1 runs
    here while the ranks run)."""
    path = tmp_path_factory.mktemp("multiaxis")
    wait = W.start("multiaxis", 4, str(path), {"dir": np.asarray(str(path))})
    world1 = {}
    for tag, (shape, n, kw, optimizer, steps, every) in RUNS.items():
        key = (n, tuple(sorted(kw.items())), optimizer, steps, every)
        if key not in world1:
            res = W.mx_train(kw, optimizer, n, steps, every)
            world1[key] = {**W.flat_tree(res.population, "p/"),
                           **W.flat_tree(res.opt_state["mu"], "mu/"),
                           "history": res.history}
        world1[tag] = world1[key]
    cli = str(path / "cli_world1")
    train_cli.main(W.MX_CLI + ["--ckpt-population", cli])
    return world1, wait(), path


def _leaves(got, tag, what="p"):
    return {k: got[f"{tag}/{what}/{k}"] for k in LEAVES}


@pytest.mark.parametrize("tag", ELEMENTWISE)
def test_elementwise_kinds_are_world_one_bitwise(runs, tag):
    world1, outs, _ = runs
    got, want = outs[0], world1[tag]
    shape, n = RUNS[tag][:2]
    for k, v in _leaves(got, tag).items():
        np.testing.assert_array_equal(v, want["p/" + k].numpy(), err_msg=k)
    for k in ("step", "comm"):
        assert got[f"{tag}/{k}"].tolist() == want["history"][k]
    np.testing.assert_allclose(got[f"{tag}/loss"], want["history"]["loss"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[f"{tag}/consensus"],
                               want["history"]["consensus"], rtol=1e-5,
                               atol=1e-6)
    pop_axes = "ens,data" if shape == (2, 2, 1) else "ens"
    assert got[f"{tag}/roles"].tolist() == [pop_axes, ""]


@pytest.mark.parametrize("tag", SPLIT_WASH)
def test_wash_on_split_members_keeps_each_shard_a_permutation(runs, tag):
    world1, outs, _ = runs
    got, want = outs[0], world1[tag]
    moved = 0
    whats = ("p", "mu") if RUNS[tag][2]["kind"] == "wash_opt" else ("p",)
    for what in whats:
        for k, v in _leaves(got, tag, what).items():
            w = want[f"{what}/{k}"].numpy()
            if not SPLIT[k]:
                np.testing.assert_array_equal(v, w, err_msg=(what, k))
                continue
            np.testing.assert_array_equal(np.sort(v, axis=0),
                                          np.sort(w, axis=0),
                                          err_msg=(what, k))
            moved += int(np.sum(v != w))
    assert moved > 0, "shard-local plans moved what the global plan did"
    assert got[f"{tag}/step"].tolist() == [0]


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 1, 4)])
def test_shard_plans_reproduce_from_the_fold(runs, shape):
    _, outs, _ = runs
    key = "x".join(map(str, shape))
    member = {"embed": {"w": torch.empty(32, 16, device="meta")},
              "blocks": {"w1": torch.empty(2, 16, 64, device="meta")},
              "head": {"w": torch.empty(16, 8, device="meta")}}
    lids = infer_layer_ids(member, 2)
    pplan = sp.plan_population_mixing(
        fake_mesh(shape), member, W.mx_specs(),
        MixingConfig(kind="wash", base_p=0.9, schedule="constant",
                     mode="bucketed"), lids, total_layers(2), 2)
    glob = shf.make_plan(W.MX_PLAN_SEED, member, lids, total_layers(2), 0.9,
                         "constant", mode="bucketed", n=2, device="cpu")
    glob = [glob["blocks"]["w1"], glob["embed"]["w"], glob["head"]["w"]]
    for i, info in enumerate(pplan.infos):
        by_model = {}
        for out in outs:
            coords = dict(zip(AXES, out[f"coords/{key}"].tolist()))
            pos = coords["model"] if info.sharded_dims else 0
            seed = leaf_seed(W.MX_PLAN_SEED, i)
            if info.sharded_dims:
                seed = fold_in(seed, pos)
            if info.layered:
                want = shf.bucketed_plan_layered(
                    seed, 2, info.d_rest_local, 2, None,
                    counts=info.counts_local, device="cpu")
            else:
                want = shf.bucketed_plan(seed, info.d_local, 2, 0.0,
                                         k_per=info.k_per_local, device="cpu")
            plan = out[f"plan/{key}/{i}"]
            np.testing.assert_array_equal(plan, want.numpy())
            by_model.setdefault(coords["model"], plan)
        plans = list(by_model.values())
        assert len(plans) == shape[2]
        if info.sharded_dims:
            assert not any(np.array_equal(plans[0], p) for p in plans[1:])
        else:
            assert all(np.array_equal(glob[i].numpy(), p) for p in plans)


def test_batch_split_mesh_is_within_the_reference_bound(runs):
    world1, outs, _ = runs
    tag = "wash_2x2x1_2"
    got, want = outs[0], world1[tag]
    assert got[f"{tag}/roles"].tolist() == ["ens", "data"]
    for k, v in _leaves(got, tag).items():
        np.testing.assert_allclose(v, want["p/" + k].numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    assert got[f"{tag}/comm"].tolist() == want["history"]["comm"]
    np.testing.assert_allclose(got[f"{tag}/loss"], want["history"]["loss"],
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_comm_is_jax_exactly_and_two_chunk_functions_at_most(runs, tag):
    _, outs, _ = runs
    shape, n, kw, optimizer, steps, every = RUNS[tag]
    per_step = jax_comm(shape, n, kw, optimizer)
    cfg = MixingConfig(**kw)
    want, total = [], 0.0
    for s in range(steps):
        if mixing_due(s, cfg):
            total += per_step
        if s in outs[0][f"{tag}/step"].tolist():
            want.append(total)
    assert outs[0][f"{tag}/comm"].tolist() == want
    assert 1 <= int(outs[0][f"{tag}/traces"]) <= 2


def test_population_files_round_trip_bitwise(runs):
    _, outs, path = runs
    got = outs[0]
    tag = "wash_opt_2x1x2_2"
    for k in LEAVES:
        np.testing.assert_array_equal(got[f"{tag}/restored/{k}"],
                                      got[f"{tag}/p/{k}"])
    sharded = np.load(path / "cli_pop.npz")
    world1 = np.load(path / "cli_world1.npz")
    assert sorted(sharded.files) == sorted(world1.files)
    for k in world1.files:
        np.testing.assert_array_equal(sharded[k], world1[k], err_msg=k)
