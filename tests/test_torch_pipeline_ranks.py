"""The pipelined engine on (ens, pipe) and (ens, data, pipe) meshes of 4
``gloo`` ranks.

One spawn of 4 ranks (``tests/torch_ring_worker.py``'s ``pipeline``
scenario, a ``FileStore`` under ``tmp_path``, one 120 s deadline) trains
``tests/test_pipeline.py``'s toy (L = 4, float32, SGD, 6 steps, a record
every 3) on the meshes of ``PP_RUNS``; here, in the parent, the port's
world-1 engine trains it (already held to JAX's vmap loop) and JAX's
planner gives the comm:

  * one stage and one microbatch is the single-stage engine bitwise
    (params, losses, comm), at world 1 in this process;
  * ``none`` and PAPA within rtol 2e-5, atol 2e-6 of world 1 (the
    reference's bound in ``test_pipelined_engine_s4_m4_matches_to_
    tolerance``), losses included, on (1,4) with M = 4, (2,2) with M = 1
    and 4, and ``ens_dp_pp`` (1,2,2) at N = 4 with M = 2 and at N = 1
    (batches split over the data axis) with M = 2;
  * WASH and WASH+Opt (AdamW) on (1,4) and (2,2): each leaf, and its
    first moment, the same multiset per coordinate across members as the
    unmixed step's; the replicated leaves bitwise on every stage of every
    run; comm equal to JAX's planner exactly; at most 2 chunk functions;
  * the gathered population and a population file round-trip bitwise;
    consensus equals the stacked function on the gathered population
    within 1e-6; the train CLI on (2, 2) writes world 1's file layout.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.core import shardplan as jsp
from repro.core.layer_index import infer_layer_ids as jlids
from repro.core.mixing import MixingConfig as JMixingConfig
from repro.sharding import rules as jrules

import torch_ring_worker as W
from repro_torch.core.mixing import MixingConfig, mixing_due
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh

RUNS = {tag: run for tag, *run in W.PP_RUNS}
ELEMENTWISE = [t for t, (_, _, _, _, kw, *_) in RUNS.items()
               if kw["kind"] in ("none", "papa") and not t.startswith("wash")]
WASH = [t for t in RUNS if t.split("_")[0] in ("wash", "washopt")]
LEAVES = ("blocks/w1", "embed/w", "head/w")
JMEMBER = {"embed": {"w": jax.ShapeDtypeStruct((16, 8), jnp.float32)},
           "blocks": {"w1": jax.ShapeDtypeStruct((4, 8, 8), jnp.float32)},
           "head": {"w": jax.ShapeDtypeStruct((8, 4), jnp.float32)}}


def jax_comm(shape, n, kw, optimizer) -> float:
    """JAX's exact scalars a member sends a mixing step on an (ens, pipe)
    mesh of ``shape``, blocks stage-split."""
    lids = jlids(JMEMBER, 4)
    specs = jrules.stage_member_specs(
        jax.tree_util.tree_map(lambda _: JP(), JMEMBER), lids, "pipe")
    mesh = types.SimpleNamespace(axis_names=("ens", "pipe"),
                                 shape=dict(ens=shape[0], pipe=shape[1]))
    pplan = jsp.plan_population_mixing(mesh, JMEMBER, specs,
                                       JMixingConfig(**kw), lids, 6, n)
    opt = ({"mu": 0, "nu": 0, "step": 0} if optimizer == "adamw"
           else {"mu": 0, "step": 0})
    return jsp.static_shard_mix_comm(pplan, opt_state=opt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' results, world 1's and the CLI's files (world 1 runs
    here while the ranks run)."""
    path = tmp_path_factory.mktemp("pipeline")
    wait = W.start("pipeline", 4, str(path), {"dir": np.asarray(str(path))})
    world1 = {}
    for tag in ELEMENTWISE:
        _, _, n, _, kw, optimizer, steps = RUNS[tag]
        key = (n, tuple(sorted(kw.items())), optimizer, steps)
        if key not in world1:
            res = W.pp_train(kw, optimizer, n, steps)
            world1[key] = {**W.flat_tree(res.population, "p/"),
                           "history": res.history}
        world1[tag] = world1[key]
    train_cli.main(W.PP_CLI + ["--ckpt-population",
                               str(path / "pp_cli_world1")])
    return world1, wait(), path


def test_one_stage_one_microbatch_is_the_engine_bitwise():
    mesh = make_host_mesh(2, "ens_pp", device="cpu")
    assert mesh.shape == {"ens": 1, "pipe": 1}
    for kw in (dict(kind="none"), W.PP_PAPA, dict(kind="wash", **W.PP_WASH)):
        want = W.pp_train(kw, "sgd", 2, W.PP_STEPS)
        got = W.pp_train(kw, "sgd", 2, W.PP_STEPS, mesh=mesh, micro=1)
        for k, v in W.flat_tree(want.population).items():
            assert np.array_equal(W.flat_tree(got.population)[k].numpy(),
                                  v.numpy()), (kw, k)
        for k in ("loss", "comm", "step", "consensus"):
            assert got.history[k] == want.history[k], (kw, k)
        assert got.comm_scalars == want.comm_scalars


@pytest.mark.parametrize("tag", ELEMENTWISE)
def test_elementwise_kinds_are_within_the_reference_bound(runs, tag):
    world1, outs, _ = runs
    got, want = outs[0], world1[tag]
    for k in LEAVES:
        np.testing.assert_allclose(got[f"{tag}/p/{k}"],
                                   want["p/" + k].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_allclose(got[f"{tag}/loss"], want["history"]["loss"],
                               rtol=2e-5, atol=2e-6)
    for k in ("step", "comm"):
        assert got[f"{tag}/{k}"].tolist() == want["history"][k]
    np.testing.assert_allclose(got[f"{tag}/consensus"][-1],
                               got[f"{tag}/stacked_consensus"], rtol=1e-6,
                               atol=1e-6)
    assert 1 <= int(got[f"{tag}/traces"]) <= 2


@pytest.mark.parametrize("tag", WASH)
def test_wash_keeps_each_coordinate_multiset(runs, tag):
    _, outs, _ = runs
    got = outs[0]
    base = tag.replace("_", "0_", 1)  # the unmixed step, same optimizer
    _, shape, n, _, kw, optimizer, _ = RUNS[tag]
    whats = ("p", "mu") if kw["kind"] == "wash_opt" else ("p",)
    moved = 0
    for what in whats:
        for k in LEAVES:
            v, w = got[f"{tag}/{what}/{k}"], got[f"{base}/{what}/{k}"]
            np.testing.assert_array_equal(np.sort(v, axis=0),
                                          np.sort(w, axis=0),
                                          err_msg=(what, k))
            moved += int(np.sum(v != w))
    assert moved > 0
    assert got[f"{tag}/step"].tolist() == [0]
    cfg = MixingConfig(**kw)
    assert mixing_due(0, cfg)
    assert got[f"{tag}/comm"].tolist() == [jax_comm(shape, n, kw, optimizer)]
    assert 1 <= int(got[f"{tag}/traces"]) <= 2


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_replicated_leaves_are_bitwise_on_every_stage(runs, tag):
    _, outs, _ = runs
    by_shard = {}
    for r, out in enumerate(outs):
        coords = out[f"{tag}/coords{r}"].tolist()
        shard = tuple(coords[:-1])  # every axis but the pipe axis
        for k in ("embed/w", "head/w"):
            by_shard.setdefault((shard, k), []).append(
                out[f"{tag}/rep{r}/{k}"])
    stages = RUNS[tag][1][-1]
    for (shard, k), replicas in by_shard.items():
        assert len(replicas) == stages
        for x in replicas[1:]:
            np.testing.assert_array_equal(x, replicas[0], err_msg=(shard, k))


def test_population_files_round_trip_bitwise(runs):
    world1, outs, path = runs
    got = outs[0]
    tag = "washopt_2x2_2_m2"
    for k in LEAVES:
        np.testing.assert_array_equal(got[f"{tag}/restored/{k}"],
                                      got[f"{tag}/p/{k}"])
    staged = np.load(path / "pp_cli.npz")
    whole = np.load(path / "pp_cli_world1.npz")
    assert sorted(staged.files) == sorted(whole.files)
    for k in whole.files:
        assert (staged[k].shape, staged[k].dtype) == (whole[k].shape,
                                                      whole[k].dtype), k
        np.testing.assert_allclose(staged[k], whole[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
