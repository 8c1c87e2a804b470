"""The port's stacked mixing and consensus metrics against the JAX package.

``mix_once`` for every kind on a reduced float32 llama3.2-3b population
(three members that differ) and its optimizer moments: JAX builds the
WASH plan, and the port's ``make_plan`` is monkeypatched to return that
plan as tensors.  Tolerances: WASH and WASH+Opt are pure data movement,
bitwise, with the comm count equal (dense WASH: exact in the port's
float64, within float32 rounding of the reference's float32); PAPA and
PAPA-all average over the ens axis, which torch and XLA sum in another
order: 1e-6 (float32).
Consensus metrics: relative 1e-5 (float32 sums in another order, the port
in column chunks).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
import importlib
from repro.core import layer_index as jli
from repro.core import mixing as jmix
from repro.core import shuffle as jshf
from repro.models import transformer as JM
from repro.optim import adamw_init as jadamw_init
from repro_torch.core import consensus as cons
from repro_torch.core import layer_index as li
from repro_torch.core import mixing as mix
from repro_torch.core import population as pop
from repro_torch.core import shuffle as shf
from repro_torch.train.interop import params_from_numpy

jcons = importlib.import_module("repro.core.consensus")  # the package
# re-exports a function of the same name
N = 3
KINDS = [("none", "dense"), ("wash", "dense"), ("wash", "bucketed"),
         ("wash_opt", "dense"), ("wash_opt", "bucketed"), ("papa", "dense"),
         ("papa_all", "dense")]


def _population():
    cfg = jget_arch("llama3.2-3b").reduced()
    member = JM.init_params(jax.random.key(0), cfg)
    keys = jax.random.split(jax.random.key(1), N)
    popn = jax.tree_util.tree_map(
        lambda x: x[None] + jax.vmap(
            lambda k: 0.1 * jax.random.normal(k, x.shape))(keys), member)
    opt = jax.vmap(jadamw_init)(popn)
    opt = {"mu": jax.tree_util.tree_map(lambda x: x + 0.5, popn),
           "nu": jax.tree_util.tree_map(lambda x: x * x, popn),
           "step": opt["step"]}
    return cfg, popn, opt


def _torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _to_torch_plan(plan):
    nplan = jax.tree_util.tree_map(np.array, plan)
    return pop.tree_map(lambda a: None if a is None else torch.from_numpy(a),
                        nplan)


def _assert_tree(got, want, exact, what):
    for (path, g), w in zip(pop.tree_paths(got), jax.tree_util.tree_leaves(want)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{what} {path}")


@pytest.mark.parametrize("kind,mode", KINDS)
def test_mix_once_matches_jax(kind, mode, monkeypatch):
    cfg, jpopn, jopt = _population()
    jcfg = jmix.MixingConfig(kind=kind, base_p=0.3, mode=mode)
    tcfg = mix.MixingConfig(kind=kind, base_p=0.3, mode=mode)
    jl = jli.infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpopn),
                             cfg.num_layers)
    tl = li.total_layers(cfg.num_layers)
    key = jax.random.key(42)
    jplan = jshf.make_plan(key, jpopn, jl, tl, 0.3, "decreasing", mode)
    calls = []

    def from_jax(seed, params, *args, **kwargs):
        calls.append(seed)
        return _to_torch_plan(jplan)

    monkeypatch.setattr(shf, "make_plan", from_jax)
    want_p, want_o, want_c = jmix.mix_once(key, jpopn, jopt, jcfg, jl, tl)

    tpopn, topt = _torch(jpopn), _torch(jopt)
    tlids = li.infer_layer_ids(pop.member(tpopn, 0), cfg.num_layers)
    got_p, got_o, got_c = mix.mix_once(5, tpopn, topt, tcfg, tlids, tl)
    assert got_p is tpopn and got_o is topt  # written in place
    exact = kind not in ("papa", "papa_all")
    _assert_tree(got_p, want_p, exact, "params")
    _assert_tree({"mu": got_o["mu"], "nu": got_o["nu"]},
                 {"mu": want_o["mu"], "nu": want_o["nu"]}, exact, "moments")
    if kind in ("wash", "wash_opt") and mode == "dense":
        # float64 in the port, float32 (rounded) in the reference
        sel = int(jshf.plan_selected_scalars(jplan, mode))
        reps = 3 if kind == "wash_opt" else 1
        assert float(got_c) == reps * (sel * (N - 1) / N)
        np.testing.assert_allclose(float(got_c), float(want_c), rtol=2 ** -23)
    else:
        assert float(got_c) == float(want_c)
    assert calls == ([5] if kind in ("wash", "wash_opt") else [])


@pytest.mark.parametrize("kind,mode", KINDS)
def test_static_mix_comm_matches_jax(kind, mode):
    cfg, jpopn, jopt = _population()
    jmember = jax.tree_util.tree_map(lambda x: x[0], jpopn)
    jl = jli.infer_layer_ids(jmember, cfg.num_layers)
    tl = li.total_layers(cfg.num_layers)
    want = jmix.static_mix_comm(
        jmember, jmix.MixingConfig(kind=kind, base_p=0.3, mode=mode), jl, tl,
        N, opt_state=jopt)
    tmember = pop.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                           pop.member(_torch(jpopn), 0))
    got = mix.static_mix_comm(
        tmember, mix.MixingConfig(kind=kind, base_p=0.3, mode=mode),
        li.infer_layer_ids(tmember, cfg.num_layers), tl, N,
        opt_state=_torch(jopt))
    assert got == want


def test_wash_preserves_distance_with_port_plans():
    _, jpopn, _ = _population()
    tpopn = _torch(jpopn)
    lids = li.infer_layer_ids(pop.member(tpopn, 0), 2)
    before = float(cons.sq_distance_to_consensus(tpopn))
    for mode in ("dense", "bucketed"):
        mix.mix_once(3, tpopn, None, mix.MixingConfig(kind="wash", base_p=0.5,
                                                      mode=mode), lids, 4)
        np.testing.assert_allclose(
            float(cons.sq_distance_to_consensus(tpopn)), before, rtol=1e-5)


def test_mixing_due_and_mix_stacked_match_jax():
    for kind in ("none", "wash", "wash_opt", "papa", "papa_all"):
        for start, stop in ((0, None), (2, 5)):
            jc = jmix.MixingConfig(kind=kind, papa_every=3, papa_all_every=4,
                                   start_step=start, stop_step=stop)
            tc = mix.MixingConfig(kind=kind, papa_every=3, papa_all_every=4,
                                  start_step=start, stop_step=stop)
            for step in range(10):
                assert mix.mixing_due(step, tc) == jmix.mixing_due(step, jc)
    x = {"w": torch.arange(6.0).reshape(2, 3)}
    out, _, comm = mix.mix_stacked(1, 0, x, None, mix.MixingConfig(
        kind="papa", papa_every=2), {"w": 0}, 3)
    assert comm == 0.0 and torch.equal(out["w"], torch.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="kind"):
        mix.mixing_due(0, mix.MixingConfig(kind="swap"))


def test_momentum_like_leaves():
    state = {"mu": {"a": 1}, "nu": {"a": 2}, "step": 3}
    assert mix.momentum_like_leaves(state, None) == {"mu": {"a": 1},
                                                    "nu": {"a": 2}}
    assert mix.momentum_like_leaves({"mu": 1, "step": 0}, None) == {"mu": 1}


def test_consensus_metrics_match_jax(monkeypatch):
    _, jpopn, _ = _population()
    tpopn = _torch(jpopn)
    monkeypatch.setattr(cons, "CHUNK", 1000)  # several chunks per leaf
    for name in ("sq_distance_to_consensus", "avg_distance_to_consensus",
                 "pairwise_distance"):
        got = float(getattr(cons, name)(tpopn))
        want = float(getattr(jcons, name)(jpopn))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    for g, w in zip(pop.tree_leaves(cons.consensus(tpopn)),
                    jax.tree_util.tree_leaves(jcons.consensus(jpopn))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
