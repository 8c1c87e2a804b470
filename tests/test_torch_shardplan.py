"""The shard-local planner, the sharding rules and the host mesh's fill
against the JAX package, in one process (JAX here, on the CPU).

  * ``classify_roles``, ``plan_population_mixing`` (every
    ``LeafShardInfo`` field), ``shard_leaf_volumes`` and
    ``static_shard_mix_comm`` / ``static_stage_mix_comm`` equal JAX's
    exactly, on mesh stand-ins (axis names and sizes, as
    ``tests/test_shardplan.py``'s ``fake_mesh``) over that file's
    ``MEMBER`` / ``SPECS`` and over reduced llama3.2-3b with the rules'
    specs, at (2,2,2), (2,1,2), (1,1,4), (2,2,1) with N in {2, 4}, for
    wash, wash_opt and papa; a pipe mesh for the stage volumes;
  * full-width llama3.2-3b's comm a step on the four-card layouts, to the
    last digit, from both planners;
  * ``param_pspecs`` equals JAX's leaf by leaf for the reduced configs of
    five families at model sizes 2 and 4;
  * the refusals, before any parameter;
  * ``host_mesh_shape`` equals the reference ``make_host_mesh``'s fill for
    1, 2, 4 and 8 devices (one subprocess with XLA's forced host device
    count).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.core import shardplan as jsp
from repro.core.layer_index import infer_layer_ids as jlids
from repro.core.mixing import MixingConfig as JMixingConfig
from repro.models import transformer as JM
from repro.sharding import rules as jrules

from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import population as pop
from repro_torch.core import shardplan as sp
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as M
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.train import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("ens", "data", "model")
MESHES = [(2, 2, 2), (2, 1, 2), (1, 1, 4), (2, 2, 1)]
KINDS = ("wash", "wash_opt", "papa")


def fake_mesh(**shape):
    """The planners read axis names and sizes alone."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


# tests/test_shardplan.py's member, in both packages
SHAPES = {"embed": {"w": (32, 16)}, "blocks": {"w1": (2, 16, 64)},
          "head": {"w": (16, 8)}}
JMEMBER = jax.tree_util.tree_map(
    lambda s: jax.ShapeDtypeStruct(s, jnp.float32), SHAPES,
    is_leaf=lambda x: isinstance(x, tuple))
MEMBER = pop.tree_map(lambda s: torch.empty(s, device="meta"), SHAPES,
                      is_leaf=lambda x: isinstance(x, tuple))
JSPECS = {"embed": {"w": JP(None, "model")},
          "blocks": {"w1": JP(None, None, "model")},
          "head": {"w": JP(None, "model")}}
SPECS = {"embed": {"w": P(None, "model")},
         "blocks": {"w1": P(None, None, "model")},
         "head": {"w": P(None, "model")}}


def _jopt(kind):
    return {"mu": 0, "nu": 0, "step": 0} if kind == "wash_opt" else None


def _plans(mesh, kind, n, jtree, ttree, jspecs, tspecs, num_blocks,
           base_p=0.5):
    jplan = jsp.plan_population_mixing(
        mesh, jtree, jspecs,
        JMixingConfig(kind=kind, base_p=base_p, mode="bucketed"),
        jlids(jtree, num_blocks), num_blocks + 2, n)
    tplan = sp.plan_population_mixing(
        mesh, ttree, tspecs,
        MixingConfig(kind=kind, base_p=base_p, mode="bucketed"),
        infer_layer_ids(ttree, num_blocks), total_layers(num_blocks), n)
    return jplan, tplan


def _same_plan(jplan, tplan):
    assert tplan.roles.roles == tuple(
        (a, sp.AxisRole(r.value)) for a, r in jplan.roles.roles)
    assert tplan.axis_sizes == jplan.axis_sizes
    assert (tplan.num_stages, tplan.n, tplan.n_local) == (
        jplan.num_stages, jplan.n, jplan.n_local)
    assert len(tplan.infos) == len(jplan.infos)
    for j, t in zip(jplan.infos, tplan.infos):
        assert dataclass_fields(t) == dataclass_fields(j)


def dataclass_fields(info) -> dict:
    return {f.name: getattr(info, f.name) for f in dataclasses.fields(info)}


def _same_comm(jplan, tplan, kind):
    assert sp.shard_leaf_volumes(tplan) == jsp.shard_leaf_volumes(jplan)
    got = sp.static_shard_mix_comm(tplan, opt_state=_jopt(kind))
    assert got == jsp.static_shard_mix_comm(jplan, opt_state=_jopt(kind))
    for s in range(tplan.num_stages):
        assert sp.static_stage_mix_comm(tplan, s, _jopt(kind)) == \
            jsp.static_stage_mix_comm(jplan, s, _jopt(kind))
    return got


def test_classify_roles_match_jax():
    for shape in [dict(ens=2, data=2, model=2), dict(ens=2, pod=2, data=2,
                                                     model=4),
                  dict(ens=4, data=4, model=16), dict(ens=1, data=1, model=1),
                  dict(ens=4), dict(ens=2, data=1, pipe=2),
                  dict(ens=2, data=2, pipe=1), dict(ens=2, data=2)]:
        for n in (2, 4, 8):
            mesh = fake_mesh(**shape)
            if n % shape["ens"]:
                continue
            want = jsp.classify_roles(mesh, n)
            got = sp.classify_roles(mesh, n)
            assert got.roles == tuple((a, sp.AxisRole(r.value))
                                      for a, r in want.roles), (shape, n)
    for bad, n in ((dict(data=2), 2), (dict(ens=3), 4)):
        with pytest.raises(ValueError):
            jsp.classify_roles(fake_mesh(**bad), n)
        with pytest.raises(ValueError):
            sp.classify_roles(fake_mesh(**bad), n)


@pytest.mark.parametrize("kind", KINDS)
def test_planner_and_comm_match_jax_on_member(kind):
    repl_j = jax.tree_util.tree_map(lambda _: JP(), JMEMBER)
    repl_t = pop.tree_map(lambda _: P(), MEMBER)
    for shape in MESHES:
        for n in (2, 4):
            mesh = fake_mesh(**dict(zip(AXES, shape)))
            for jspecs, tspecs in ((JSPECS, SPECS), (repl_j, repl_t)):
                jplan, tplan = _plans(mesh, kind, n, JMEMBER, MEMBER, jspecs,
                                      tspecs, 2)
                _same_plan(jplan, tplan)
                _same_comm(jplan, tplan, kind)


@pytest.fixture(scope="module")
def llama_reduced():
    jcfg = jget_arch("llama3.2-3b").reduced()
    cfg = get_arch("llama3.2-3b").reduced()
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    return jcfg, cfg, jtree, M.param_shapes(cfg)


@pytest.mark.parametrize("kind", KINDS)
def test_planner_and_comm_match_jax_on_reduced_llama(llama_reduced, kind):
    jcfg, cfg, jtree, ttree = llama_reduced
    for shape in MESHES:
        mesh = fake_mesh(**dict(zip(AXES, shape)))
        jspecs = jrules.param_pspecs(jtree, jcfg, mesh)
        tspecs = rules.param_pspecs(ttree, cfg, mesh)
        for n in (2, 4):
            jplan, tplan = _plans(mesh, kind, n, jtree, ttree, jspecs, tspecs,
                                  cfg.num_layers, base_p=0.3)
            _same_plan(jplan, tplan)
            assert _same_comm(jplan, tplan, kind) > 0


def test_stage_volumes_match_jax_and_sum_to_the_plan_total(llama_reduced):
    """A pipe axis of 2: the per-stage budgets and volumes equal JAX's and
    sum to the plan's total exactly."""
    jcfg, cfg, jtree, ttree = llama_reduced
    mesh = fake_mesh(ens=2, data=1, pipe=2)
    cases = [(JMEMBER, MEMBER, 2), (jtree, ttree, cfg.num_layers)]
    for jt, tt, nb in cases:
        jrepl = jax.tree_util.tree_map(lambda _: JP(), jt)
        jstaged = jrules.stage_member_specs(jrepl, jlids(jt, nb), "pipe")
        tstaged = pop.tree_map(
            lambda lid: P() if isinstance(lid, int) else P("pipe"),
            infer_layer_ids(tt, nb))
        for kind in KINDS:
            jplan, tplan = _plans(mesh, kind, 4, jt, tt, jstaged, tstaged, nb)
            assert tplan.num_stages == 2
            _same_plan(jplan, tplan)
            total = _same_comm(jplan, tplan, kind)
            per_stage = [sp.static_stage_mix_comm(tplan, s, _jopt(kind))
                         for s in range(2)]
            assert sum(per_stage) == total and total > 0
    with pytest.raises(ValueError, match="stage"):
        sp.static_stage_mix_comm(tplan, 2)


# full-width llama3.2-3b, N=2 unless said, bucketed p = 0.01: WASH and
# WASH+Opt (AdamW) scalars a member sends a mixing step
LLAMA_COMM = {((1, 1, 1), 2): (9016867.0, 27050601.0),
              ((2, 1, 2), 2): (9016816.0, 27050448.0),
              ((1, 1, 4), 2): (9016712.0, 27050136.0),
              ((2, 2, 1), 2): (9016867.0, 27050601.0),
              ((2, 2, 1), 4): (13525293.0, 40575879.0)}


def test_full_width_llama_comm_to_the_last_digit():
    jcfg, cfg = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    ttree = M.param_shapes(cfg)
    for (shape, n), want in LLAMA_COMM.items():
        mesh = fake_mesh(**dict(zip(AXES, shape)))
        tspecs = rules.param_pspecs(ttree, cfg, mesh)
        jspecs = jrules.param_pspecs(jtree, jcfg, mesh)
        got = []
        for kind in ("wash", "wash_opt"):
            jplan, tplan = _plans(mesh, kind, n, jtree, ttree, jspecs, tspecs,
                                  cfg.num_layers, base_p=0.01)
            _same_plan(jplan, tplan)
            got.append(_same_comm(jplan, tplan, kind))
        assert tuple(got) == want, (shape, n)
        split = sum(bool(i.sharded_dims) for i in tplan.infos)
        assert split == (9 if shape[2] > 1 else 0)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-lite-16b",
                                  "rwkv6-3b", "hymba-1.5b", "whisper-medium"])
def test_param_pspecs_match_jax_leaf_by_leaf(arch):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    ttree = M.param_shapes(cfg)
    for model in (2, 4):
        mesh = fake_mesh(ens=1, data=1, model=model)
        want = jax.tree_util.tree_flatten_with_path(
            jrules.param_pspecs(jtree, jcfg, mesh),
            is_leaf=lambda x: isinstance(x, JP))[0]
        got = list(pop.tree_paths(rules.param_pspecs(ttree, cfg, mesh),
                                  is_leaf=rules.is_spec))
        assert len(got) == len(want) > 5
        split = 0
        for (jpath, jspec), (tpath, tspec) in zip(want, got):
            assert tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in jpath) == tuple(map(str, tpath))
            assert tuple(tspec) == tuple(jspec), (tpath, tspec, jspec)
            split += "model" in tspec
        assert split > 0


def test_population_and_opt_specs_match_jax(llama_reduced):
    jcfg, cfg, jtree, ttree = llama_reduced
    mesh = fake_mesh(ens=2, data=2, model=2)
    jm = jrules.param_pspecs(jtree, jcfg, mesh)
    tm = rules.param_pspecs(ttree, cfg, mesh)
    for pop_axes in (("ens",), ("ens", "data")):
        jp = jrules.population_pspecs(jm, pop_axes)
        tp = rules.population_pspecs(tm, pop_axes)
        jo = jrules.opt_pspecs({"mu": jtree, "nu": jtree, "step": 0}, jp,
                               pop_axes)
        to = rules.opt_pspecs({"mu": ttree, "nu": ttree,
                               "step": torch.zeros(2)}, tp, pop_axes)
        for j, t in ((jp, tp), (jo, to)):
            want = jax.tree_util.tree_leaves(
                j, is_leaf=lambda x: isinstance(x, JP))
            got = pop.tree_leaves(t, is_leaf=rules.is_spec)
            assert [tuple(x) for x in got] == [tuple(x) for x in want]
        assert tuple(to["step"]) == (pop_axes[0] if len(pop_axes) == 1
                                     else pop_axes,)


def _never(seed):
    raise AssertionError("a parameter was made")


def test_refusals_come_before_any_parameter(monkeypatch):
    mesh = fake_mesh(ens=2, data=2, model=2)
    for bad in ({**SPECS, "head": {"w": P(None, "ens")}},
                {**SPECS, "head": {"w": P("data", None)}}):
        with pytest.raises(ValueError, match="population/batch"):
            sp.plan_population_mixing(
                mesh, MEMBER, bad, MixingConfig(kind="wash", mode="bucketed"),
                infer_layer_ids(MEMBER, 2), 4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        sp.plan_population_mixing(
            fake_mesh(ens=1, data=1, model=3), MEMBER, SPECS,
            MixingConfig(kind="wash", mode="bucketed"),
            infer_layer_ids(MEMBER, 2), 4, 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="has 2 ranks; the world has 4"):
        tmesh.make_host_mesh(2, "ens_dp_mp", mesh_shape=(2, 1, 1),
                             device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(3, "ens_dp_mp", mesh_shape=(3, 1, 1),
                             device="cpu")
    # the pipe axis's fill: stages that do not divide the ranks left after
    # the ens axis, a shape larger than the world
    with pytest.raises(ValueError, match="pp_stages=3 must divide"):
        tmesh.make_host_mesh(2, "ens_pp", pp_stages=3, device="cpu")
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_host_mesh(2, "ens_dp_pp", mesh_shape=(1, 2, 4),
                             device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    tcfg = TrainConfig(population=2, total_steps=1)
    wash = MixingConfig(kind="wash", mode="bucketed")
    with pytest.raises(ValueError, match="multi-axis"):
        engine.train_population_sharded(
            0, _never, None, None, tcfg, wash, 2, param_specs=SPECS,
            device="cpu")
    with pytest.raises(ValueError, match="multi-axis"):
        engine.train_population_sharded(
            0, _never, None, None, tcfg, wash, 2, param_specs=SPECS,
            mesh=tmesh.make_host_ensemble_mesh(2, "cpu"), device="cpu")
    host = tmesh.make_host_mesh(2, "ens_dp_mp", device="cpu")
    assert host.shape == {"ens": 1, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="population/batch"):
        engine.train_population_sharded(
            0, _never, None, None, tcfg, wash, 2, mesh=host, device="cpu",
            param_specs={**SPECS, "head": {"w": P("ens", None)}})


KINDS_FILLED = ("ens", "ens_dp", "ens_dp_mp", "ens_pp", "ens_dp_pp")


def test_host_mesh_fill_matches_the_reference():
    """The reference's ``make_host_mesh`` on 1, 2, 4 and 8 of a forced
    8-device host (``jax.devices`` cut to the first k), every kind, N in
    {1, 2, 3, 4, 8}, and the pipe kinds with pp_stages 2 and 4 (refused
    where they do not divide)."""
    src = textwrap.dedent("""
        import json
        import jax
        from repro.launch import mesh as m
        real = jax.devices
        assert len(real()) == 8
        m._mk = lambda shape, axes: dict(zip(axes, shape))
        out = []
        for k in (1, 2, 4, 8):
            jax.devices = lambda k=k: real()[:k]
            for kind in %r:
                for n in (1, 2, 3, 4, 8):
                    for pp in (None, 2, 4):
                        if pp and "pipe" not in m.HOST_MESH_AXES[kind]:
                            continue
                        try:
                            got = m.make_host_mesh(n, kind, pp_stages=pp)
                        except ValueError:
                            got = None
                        out.append([k, kind, n, pp, got])
        jax.devices = real
        print(json.dumps(out))
    """ % (KINDS_FILLED,))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(rows) == 4 * len(KINDS_FILLED) * 5 + 4 * 2 * 5 * 2
    for k, kind, n, pp, want in rows:
        try:
            got = dict(zip(tmesh.HOST_MESH_AXES[kind],
                           tmesh.host_mesh_shape(n, kind, k, pp_stages=pp)))
        except ValueError:
            got = None
        assert got == want, (k, kind, n, pp)
