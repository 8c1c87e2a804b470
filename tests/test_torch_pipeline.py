"""The pipeline axis's host-side pieces against the JAX package, in one
process (JAX here, on the CPU).

  * ``rules.stage_member_specs`` equals JAX's leaf by leaf on reduced
    llama3.2-3b and on ``tests/test_pipeline.py``'s toy; a list-of-blocks
    member stays replicated; a layer axis already split is refused;
  * ``pipeline_supported`` gives JAX's verdict and text for every config
    and its reduced variant, and ``depth_histogram`` JAX's counts;
  * the stage functions, with the blocks cut into stage slices and
    composed, equal JAX's ``pipeline_stage_fns`` composition and JAX's
    ``loss_fn`` nll within 1e-5 (reduced llama3.2-3b in float32 and a
    4-layer cut, JAX's weights carried across as numpy);
  * the comm of full-width llama3.2-3b on the (ens, pipe) layouts, a
    step and each stage's share, to the last digit from both planners,
    and the toy's;
  * each stage's plan lies in ``[0, d_local)`` with disjoint rows, its
    width is JAX's ``stage_k_per[s]``, its per-layer counts those of
    the stage's layers, and it reproduces from ``fold_in(leaf_key, s)``;
  * the pipelined engine's refusals and the CLI's ``pipeline_supported``
    come before any parameter is made.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.core import shardplan as jsp
from repro.core.layer_index import depth_histogram as jdepth_histogram
from repro.core.layer_index import infer_layer_ids as jlids
from repro.core.mixing import MixingConfig as JMixingConfig
from repro.models import transformer as JM
from repro.sharding import rules as jrules

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import population as pop
from repro_torch.core import shardplan as sp
from repro_torch.core import shuffle as shf
from repro_torch.core.layer_index import (depth_histogram, infer_layer_ids,
                                          total_layers)
from repro_torch.core.mixing import MixingConfig
from repro_torch.core.prng import fold_in, leaf_seed
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as M
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.train import engine
from repro_torch.train.interop import params_from_numpy


def fake_mesh(**shape):
    """The planners read axis names and sizes alone."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


# tests/test_pipeline.py's toy member (L=4) and a list-of-blocks member
TOY = {"embed": {"w": (16, 8)}, "blocks": {"w1": (4, 8, 8)},
       "head": {"w": (8, 4)}}
LISTED = {"embed": {"w": (16, 8)}, "blocks": [{"w1": (8, 8)},
                                              {"w1": (8, 8)}],
          "head": {"w": (8, 4)}}


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def jtree(shapes):
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=_is_shape)


def ttree(shapes):
    return pop.tree_map(lambda s: torch.empty(s, device="meta"), shapes,
                        is_leaf=_is_shape)


@pytest.fixture(scope="module")
def llama_reduced():
    jcfg = jget_arch("llama3.2-3b").reduced()
    cfg = get_arch("llama3.2-3b").reduced()
    return (jcfg, cfg,
            jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg)),
            M.param_shapes(cfg))


def _specs_equal(jspecs, tspecs):
    want = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]
    got = list(pop.tree_paths(tspecs, is_leaf=rules.is_spec))
    assert len(got) == len(want) > 0
    for (jpath, jspec), (tpath, tspec) in zip(want, got):
        assert tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in jpath) == tuple(map(str, tpath))
        assert tuple(tspec) == tuple(jspec), (tpath, tspec, jspec)
    return [tuple(s) for _, s in got]


def test_stage_member_specs_match_jax(llama_reduced):
    jcfg, cfg, jt, tt = llama_reduced
    cases = [(jt, tt, cfg.num_layers), (jtree(TOY), ttree(TOY), 4),
             (jtree(LISTED), ttree(LISTED), 2)]
    for jm, tm, nb in cases:
        jl, tl = jlids(jm, nb), infer_layer_ids(tm, nb)
        jrepl = jax.tree_util.tree_map(lambda _: JP(), jm)
        trepl = pop.tree_map(lambda _: P(), tm)
        got = _specs_equal(jrules.stage_member_specs(jrepl, jl, "pipe"),
                           rules.stage_member_specs(trepl, tl, "pipe"))
        stacked = sum(not isinstance(i, int) for i in pop.tree_leaves(tl))
        assert sum(s == ("pipe",) for s in got) == stacked
    # the list-of-blocks member stays replicated everywhere
    listed = rules.stage_member_specs(
        pop.tree_map(lambda _: P(), ttree(LISTED)),
        infer_layer_ids(ttree(LISTED), 2), "pipe")
    assert all(s == P()
               for s in pop.tree_leaves(listed, is_leaf=rules.is_spec))
    staged = rules.stage_member_specs(
        pop.tree_map(lambda _: P(), ttree(TOY)),
        infer_layer_ids(ttree(TOY), 4), "pipe")
    assert staged["blocks"]["w1"] == P("pipe")
    assert staged["embed"]["w"] == P() and staged["head"]["w"] == P()
    # a layer axis already split by another axis is refused by both
    bad = {"embed": {"w": P()}, "blocks": {"w1": P("model", None, None)},
           "head": {"w": P()}}
    jbad = {"embed": {"w": JP()}, "blocks": {"w1": JP("model", None, None)},
            "head": {"w": JP()}}
    with pytest.raises(ValueError, match="stage-split"):
        jrules.stage_member_specs(jbad, jlids(jtree(TOY), 4), "pipe")
    with pytest.raises(ValueError, match="stage-split"):
        rules.stage_member_specs(bad, infer_layer_ids(ttree(TOY), 4), "pipe")


def test_pipeline_supported_and_depth_histogram_match_jax():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    verdicts = {}
    for arch in ARCH_IDS:
        for reduce in (False, True):
            jcfg, cfg = jget_arch(arch), get_arch(arch)
            if reduce:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            want = JM.pipeline_supported(jcfg)
            assert M.pipeline_supported(cfg) == want, arch
            verdicts[arch] = want
            if want is not None:
                with pytest.raises(NotImplementedError) as e:
                    M.pipeline_stage_fns(cfg)
                assert str(e.value) == f"pipelined training: {want}"
            if reduce:
                jt = jax.eval_shape(
                    lambda: JM.init_params(jax.random.key(0), jcfg))
                jz = jax.tree_util.tree_map(
                    lambda x: np.zeros(x.shape, np.int8), jt)
                got = depth_histogram(M.param_shapes(cfg), cfg.num_layers)
                assert got == jdepth_histogram(jz, jcfg.num_layers), arch
    assert {a for a, v in verdicts.items() if v is None} == {
        "llama3.2-3b", "qwen1.5-4b", "qwen3-4b", "minitron-8b"}


def _jax_and_torch_params(jcfg):
    jp = JM.init_params(jax.random.key(3), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("layers,stages", [(2, 2), (4, 4)])
def test_stage_fns_compose_to_the_jax_loss(layers, stages):
    jcfg = jget_arch("llama3.2-3b").reduced(num_layers=layers)
    cfg = get_arch("llama3.2-3b").reduced(num_layers=layers)
    jp, tp = _jax_and_torch_params(jcfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    je, jblk, jh = JM.pipeline_stage_fns(jcfg)
    te, tblk, th = M.pipeline_stage_fns(cfg)
    per = layers // stages
    jx, tx = je(jp, jb), te(tp, tb)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    for s in range(stages):
        def cut(p, s=s):
            return {**p, "blocks": jax.tree_util.tree_map(
                lambda x: x[s * per:(s + 1) * per], p["blocks"])}
        jx = jblk(cut(jp), jx)
        tx = tblk({**tp, "blocks": pop.tree_map(
            lambda x: x[s * per:(s + 1) * per], tp["blocks"])}, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
    got = float(th(tp, tx, tb))
    want_composed = float(jh(jp, jx, jb))
    _, aux = JM.loss_fn(jp, jcfg, jb)
    assert got == pytest.approx(want_composed, rel=1e-5, abs=1e-5)
    assert got == pytest.approx(float(aux["nll"]), rel=1e-5, abs=1e-5)
    # the port's composition is its own loss_fn's nll, bitwise
    assert got == float(M.loss_fn(tp, cfg, tb)[1]["nll"])


def _stage_plans(jt, tt, nb, shape, kind, n, base_p):
    mesh = fake_mesh(**shape)
    jl, tl = jlids(jt, nb), infer_layer_ids(tt, nb)
    jspecs = jrules.stage_member_specs(
        jax.tree_util.tree_map(lambda _: JP(), jt), jl, "pipe")
    tspecs = rules.stage_member_specs(pop.tree_map(lambda _: P(), tt), tl,
                                      "pipe")
    jplan = jsp.plan_population_mixing(
        mesh, jt, jspecs, JMixingConfig(kind=kind, base_p=base_p,
                                        mode="bucketed"), jl, nb + 2, n)
    tplan = sp.plan_population_mixing(
        mesh, tt, tspecs, MixingConfig(kind=kind, base_p=base_p,
                                       mode="bucketed"), tl,
        total_layers(nb), n)
    return jplan, tplan


def _comm(plan, mod, kind):
    opt = {"mu": 0, "nu": 0, "step": 0} if kind == "wash_opt" else None
    return (mod.static_shard_mix_comm(plan, opt_state=opt),
            [mod.static_stage_mix_comm(plan, s, opt)
             for s in range(plan.num_stages)])


# full-width llama3.2-3b, bucketed p = 0.01, stage_member_specs over
# replicated specs: ((ens, pipe), N) -> (WASH a step, its stages), (WASH+Opt
# under AdamW a step, its stages), from the reference's planner
PIPE_COMM = {
    ((1, 1), 2): ((9016867.0, None), (27050601.0, None)),
    ((1, 2), 2): ((9016865.0, [7194405.0, 1822460.0]),
                  (27050595.0, [21583215.0, 5467380.0])),
    ((2, 2), 2): ((9016865.0, [7194405.0, 1822460.0]),
                  (27050595.0, [21583215.0, 5467380.0])),
    ((2, 2), 4): ((13525281.0, [10791597.0, 2733684.0]),
                  (40575843.0, [32374791.0, 8201052.0])),
    ((1, 4), 2): ((9016861.0, [5007447.0, 2186954.0, 1336474.0, 485986.0]),
                  (27050583.0, [15022341.0, 6560862.0, 4009422.0,
                                1457958.0])),
    ((1, 4), 4): ((13525281.0, [7511166.0, 3280431.0, 2004705.0, 728979.0]),
                  (40575843.0, [22533498.0, 9841293.0, 6014115.0,
                                2186937.0])),
}


def test_pipeline_comm_to_the_last_digit():
    jcfg, cfg = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
    jt = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    tt = M.param_shapes(cfg)
    for (shape, n), want in PIPE_COMM.items():
        for kind, (total, stages) in zip(("wash", "wash_opt"), want):
            jplan, tplan = _stage_plans(jt, tt, cfg.num_layers,
                                        dict(ens=shape[0], pipe=shape[1]),
                                        kind, n, 0.01)
            assert [dataclasses.asdict(i) for i in tplan.infos] == [
                dataclasses.asdict(j) for j in jplan.infos]
            got, got_stages = _comm(tplan, sp, kind)
            assert (got, got_stages) == _comm(jplan, jsp, kind)
            assert got == total, (shape, n, kind)
            if stages is not None:
                assert got_stages == stages and sum(stages) == total
    # the toy, every mixing kind, on (2, 2), (1, 4) at N = 2 and 4
    for shape in ((2, 2), (1, 4)):
        for n in (2, 4):
            for kind in ("wash", "wash_opt", "papa", "none"):
                jplan, tplan = _stage_plans(
                    jtree(TOY), ttree(TOY), 4,
                    dict(ens=shape[0], pipe=shape[1]), kind, n, 0.5)
                assert _comm(tplan, sp, kind) == _comm(jplan, jsp, kind)


@pytest.mark.parametrize("n,stages", [(2, 2), (2, 4), (4, 4)])
def test_stage_plans_lie_in_the_stage_and_reproduce(n, stages):
    jcfg = jget_arch("llama3.2-3b").reduced(num_layers=4)
    cfg = get_arch("llama3.2-3b").reduced(num_layers=4)
    jt = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    tt = M.param_shapes(cfg)
    jplan, tplan = _stage_plans(jt, tt, 4, dict(ens=1, pipe=stages), "wash",
                                n, 0.3)
    seed, split = 21, 0
    for s in range(stages):
        mesh = types.SimpleNamespace(
            axis_names=("ens", "pipe"), shape={"ens": 1, "pipe": stages},
            coords={"ens": 0, "pipe": s}, device=torch.device("cpu"))
        plans = sp.build_local_plans(seed, tplan, mesh)
        for info, jinfo, plan in zip(tplan.infos, jplan.infos, plans):
            if not info.stage_split:
                continue
            split += 1
            lo, hi = info.stage_bounds[s]
            assert plan.shape == (n, jinfo.stage_k_per[s])
            assert plan.dtype == torch.int32
            flat = plan.flatten().long()
            assert int(flat.min()) >= 0 and int(flat.max()) < info.d_local
            assert info.d_local == (hi - lo) * info.d_rest_local
            assert flat.unique().numel() == flat.numel()  # rows disjoint
            per_layer = torch.bincount(flat // info.d_rest_local,
                                       minlength=hi - lo).tolist()
            counts = [min(c, info.d_rest_local)
                      for c in info.counts_local[lo:hi]]
            # the pool of the stage's layers, less its remainder of N
            assert all(0 <= c - g for g, c in zip(per_layer, counts))
            assert sum(counts) - sum(per_layer) == sum(counts) % n
            want = shf.bucketed_plan_layered(
                fold_in(leaf_seed(seed, info.index), s), hi - lo,
                info.d_rest_local, n, None, counts=info.counts_local[lo:hi],
                device="cpu")
            assert torch.equal(plan, want)
    assert split > 0


def test_stage_plan_counts_equal_the_stage_layers_when_they_divide():
    """Layers whose counts pool to a multiple of N: each stage's plan
    holds exactly its layers' counts."""
    member = {"blocks": {"w": torch.empty(4, 10, device="meta")}}
    lids = infer_layer_ids(member, 4)
    specs = rules.stage_member_specs({"blocks": {"w": P()}}, lids)
    pplan = sp.plan_population_mixing(
        fake_mesh(ens=1, pipe=2), member, specs,
        MixingConfig(kind="wash", base_p=0.4, schedule="constant",
                     mode="bucketed"), lids, total_layers(4), 2)
    info = pplan.infos[0]
    assert info.counts_local == (4, 4, 4, 4)
    for s in range(2):
        mesh = types.SimpleNamespace(coords={"pipe": s},
                                     device=torch.device("cpu"))
        plan = sp.build_local_plans(5, pplan, mesh)[0]
        per_layer = torch.bincount(plan.flatten().long() // 10).tolist()
        assert per_layer == [4, 4]


def _never(seed):
    raise AssertionError("a parameter was made")


def _pipe_mesh(stages, n):
    """A HostMesh of one population shard and ``stages`` pipe ranks, as
    rank 0 of such a world sees it (its groups are never used: every
    refusal comes before a collective)."""
    roles = sp.classify_roles(fake_mesh(ens=1, pipe=stages), n)
    one = tmesh.AxisGroup((), 0, 1)
    return tmesh.HostMesh(
        axis_names=("ens", "pipe"), shape={"ens": 1, "pipe": stages},
        coords={"ens": 0, "pipe": 0}, roles=roles, rank=0,
        device=torch.device("cpu"),
        pop=tmesh.EnsMesh(0, 1, n, 0, torch.device("cpu")), data=one,
        model=one, loss=one, pipe=tmesh.AxisGroup(("pipe",), 0, stages),
        next_rank=1)


def _toy_data(m, step, seed):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(8, 16, generator=g),
            "y": torch.randn(8, 4, generator=g)}


def test_refusals_come_before_any_parameter(monkeypatch):
    fns = (lambda p, b: b["x"], lambda p, x: x, lambda p, x, b: x.sum())
    tcfg = TrainConfig(population=2, total_steps=2)
    none = MixingConfig(kind="none")

    def run(mcfg=none, tpl=TOY, stages=4, micro=1, mesh=None, blocks=4):
        engine.train_population_pipelined(
            0, _never, fns, _toy_data, tcfg, mcfg, blocks,
            mesh=mesh or _pipe_mesh(stages, 2), microbatches=micro,
            member_tpl=ttree(tpl), device="cpu")

    with pytest.raises(ValueError, match="bucketed"):
        run(MixingConfig(kind="wash", mode="dense"))
    with pytest.raises(ValueError, match="stacked-blocks"):
        run(tpl=LISTED)
    with pytest.raises(ValueError, match="split evenly"):
        run(tpl={**TOY, "blocks": {"w1": (6, 8, 8)}}, blocks=6)
    with pytest.raises(ValueError, match="microbatches"):
        run(micro=3)
    with pytest.raises(ValueError, match="microbatches must be"):
        run(micro=0)
    with pytest.raises(ValueError, match="'pipe' axis"):
        run(mesh=tmesh.make_host_ensemble_mesh(2, "cpu"))
    # the CLI asks pipeline_supported, and the mesh's fill, first
    monkeypatch.setattr(M, "init_params", _never)
    argv = ["--reduced", "--device", "cpu", "--population", "2",
            "--mode", "bucketed", "--steps", "1", "--batch-size", "2",
            "--seq-len", "8", "--engine", "shard_map", "--mesh", "ens_pp"]
    for arch in ("rwkv6-3b", "hymba-1.5b", "whisper-medium",
                 "internvl2-76b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"):
        with pytest.raises(NotImplementedError, match="pipelined training"):
            train_cli.main(["--arch", arch] + argv)
    with pytest.raises(ValueError, match="pp_stages=2"):
        train_cli.main(["--arch", "llama3.2-3b", "--pp-stages", "2"] + argv)
    with pytest.raises(ValueError, match="microbatches"):
        train_cli.main(["--arch", "llama3.2-3b", "--microbatches", "4"]
                       + argv)
