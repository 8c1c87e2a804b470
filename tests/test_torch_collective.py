"""The ensemble engine's collectives against the JAX package.

One spawn of 4 ``gloo`` ranks (``tests/torch_ring_worker.py``, a
``FileStore`` under ``tmp_path``) runs the port's ring applies, mixing,
plan draws and gather on rank subgroups; JAX runs here, in the parent,
and the children get its inputs and plans as numpy arrays.

  * ``bucketed_apply_collective_blocked`` is bitwise equal to JAX's
    ``bucketed_apply_stacked`` on JAX's ``bucketed_plan`` for n members
    over m ranks, (n, m) in {(4, 1), (4, 2), (4, 4), (6, 3), (8, 2),
    (8, 4)}, float32 and bfloat16, at a width that is a multiple of no
    block; (6, 3) is a ring of 3 ranks with 2 members each (the
    ``q + 1`` exchange of ``_block_from``), on ranks [1, 2, 3], whose
    group ranks are not their global ranks (as [2, 3] at m = 2);
  * ``apply_plan_collective`` at one member a rank;
  * ``mix_collective_blocked`` against JAX's ``mix_stacked`` on the same
    plan: WASH and WASH+Opt bitwise, moments included; PAPA and PAPA-all
    within 1e-6;
  * the plan every rank draws from one seed is the same;
  * ``gather_population`` rebuilds the stack bitwise on rank 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import shuffle as jshf
from repro.core.layer_index import infer_layer_ids, total_layers

import torch_ring_worker as W
from repro_torch.core import shuffle as shf
from repro_torch.kernels import ops
from repro_torch.launch.mesh import EnsMesh

WORLD = 4
MIX_STEP = 10  # a PAPA / PAPA-all period's step


def _toy_population(rng):
    """The toy tree (embed 16x8, one 8x8 block, head 8x4) of 4 members."""
    return {"embed": {"w": rng.standard_normal((4, 16, 8), np.float32)},
            "blocks": [{"w1": rng.standard_normal((4, 8, 8), np.float32)}],
            "head": {"w": rng.standard_normal((4, 8, 4), np.float32)}}


def _flat(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = None if leaf is None else np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """JAX's inputs and expectations, and the 4 ranks' results (the ranks
    run while JAX computes what they should give)."""
    rng = np.random.default_rng(3)
    key = jax.random.key(5)
    plan_of = jax.jit(jshf.bucketed_plan, static_argnums=(1, 2, 3))
    inputs = {}
    for i, n in enumerate(sorted({n for n, _ in W.RING_CASES})):
        inputs[f"ring_x_{n}"] = rng.standard_normal((n, W.RING_WIDTH),
                                                    np.float32)
        inputs[f"ring_idx_{n}"] = np.asarray(plan_of(
            jax.random.fold_in(key, i), W.RING_WIDTH, n, 0.8))
    inputs["one_x"] = rng.standard_normal((WORLD, 5, 7), np.float32)
    inputs["one_idx"] = np.asarray(plan_of(jax.random.fold_in(key, 9), 35,
                                           WORLD, 0.9))
    popn = jax.tree_util.tree_map(jnp.asarray, _toy_population(rng))
    opt = {"mu": jax.tree_util.tree_map(
               lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32)),
               popn),
           "nu": jax.tree_util.tree_map(
               lambda x: jnp.asarray(rng.random(x.shape, np.float32)), popn)}
    lids = infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], popn), 1)
    mkey = jax.random.fold_in(key, 17)
    plan = jax.jit(lambda k, p: jshf.make_plan(
        k, p, lids, total_layers(1), 0.5, "decreasing", "bucketed"))(
            mkey, popn)
    for k, v in _flat(popn).items():
        inputs["pop/" + k] = v
    for name in ("mu", "nu"):
        for k, v in _flat(opt[name]).items():
            inputs[f"{name}/{k}"] = v
    for k, v in _flat(plan, is_leaf=lambda x: x is None).items():
        if v is not None:
            inputs["plan/" + k] = v
    assert any(k.startswith("plan/") for k in inputs)
    inputs["gather_x"] = rng.standard_normal((2 * WORLD, 3, 5), np.float32)
    wait = W.start("collective", WORLD, str(tmp_path_factory.mktemp("ring")),
                   inputs)

    want = {}
    roll = jax.jit(jshf.bucketed_apply_stacked)
    for n in sorted({n for n, _ in W.RING_CASES}):
        for dt in ("float32", "bfloat16"):
            xj = jnp.asarray(inputs[f"ring_x_{n}"]).astype(dt)
            want[n, dt] = np.asarray(roll(xj, inputs[f"ring_idx_{n}"])
                                     .astype(jnp.float32))
    want["one"] = np.asarray(roll(jnp.asarray(inputs["one_x"]),
                                  inputs["one_idx"]))
    for kind in W.MIX_KINDS:
        cfg = jmix.MixingConfig(kind=kind, base_p=0.5, mode="bucketed",
                                papa_alpha=0.9, papa_every=MIX_STEP,
                                papa_all_every=MIX_STEP)
        p2, o2, _ = jax.jit(lambda k, p, o: jmix.mix_stacked(
            MIX_STEP, k, p, o, cfg, lids, total_layers(1)))(mkey, popn, opt)
        want["mix", kind] = {"p": _flat(p2), "mu": _flat(o2["mu"]),
                             "nu": _flat(o2["nu"])}
    return inputs, want, wait()


def _assembled(outs, key, m):
    """The stacked result of each rank group of size m (ranks' blocks in
    group order)."""
    if m == 1:
        return [o[key] for o in outs]
    return [np.concatenate([outs[r][key] for r in g]) for g in W.GROUPS[m]]


def _bits(a):
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", W.RING_CASES)
def test_blocked_ring_apply_is_jax_stacked_roll_bitwise(ring, n, m, dtype):
    _, want, outs = ring
    got = _assembled(outs, f"ring_{n}_{m}_{dtype}", m)
    assert got
    for g in got:
        assert g.shape == (n, W.RING_WIDTH)
        np.testing.assert_array_equal(_bits(g), _bits(want[n, dtype]))


def test_one_member_a_rank_apply_is_jax_stacked_roll_bitwise(ring):
    _, want, outs = ring
    got = np.stack([o["one"] for o in outs])
    np.testing.assert_array_equal(_bits(got), _bits(want["one"]))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", W.MIX_KINDS)
def test_mix_collective_blocked_matches_jax_mix_stacked(ring, kind, m):
    """WASH and WASH+Opt bitwise (the moments too: replayed under
    WASH+Opt, untouched otherwise); PAPA and PAPA-all within 1e-6."""
    _, want, outs = ring
    exact = kind in ("wash", "wash_opt")
    for part in ("p", "mu", "nu"):
        for k, w in want["mix", kind][part].items():
            for g in _assembled(outs, f"mix_{kind}_{m}/{part}/{k}", m):
                if exact or part != "p":
                    np.testing.assert_array_equal(_bits(g), _bits(w),
                                                  err_msg=f"{part}/{k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                               err_msg=f"{part}/{k}")


def test_every_rank_draws_the_same_plan(ring):
    _, _, outs = ring
    for o in outs:
        sums = o["plan_checksums"]
        assert sums.shape == (WORLD,) and sums[0] > 0
        assert (sums == sums[0]).all(), sums


def test_gather_population_rebuilds_the_stack_on_rank_zero(ring):
    inputs, _, outs = ring
    np.testing.assert_array_equal(outs[0]["gathered"], inputs["gather_x"])
    assert all("gathered" not in o for o in outs[1:])


def test_world_one_sends_each_planned_leaf_through_the_shuffle_route(
        monkeypatch):
    """At world 1 each planned leaf goes whole through
    ``ops.bucketed_shuffle_`` (the CUDA kernel on the card), and the
    result is the blocked ring apply's."""
    calls = []
    route = ops.bucketed_shuffle_

    def counted(x, idx):
        calls.append(tuple(x.shape))
        return route(x, idx)

    monkeypatch.setattr(ops, "bucketed_shuffle_", counted)
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, 5, generator=g), "b": torch.randn(3, 2),
            "c": torch.randn(3, 7, generator=g)}
    want = {k: v.clone() for k, v in tree.items()}
    plan = {"a": shf.bucketed_plan(1, 20, 3, 0.6, device="cpu"), "b": None,
            "c": shf.bucketed_plan(2, 7, 3, 0.9, device="cpu")}
    mesh = EnsMesh(0, 1, 3, 0, torch.device("cpu"))
    out = shf.apply_plan_collective_blocked(plan, tree, mesh)
    assert all(out[k] is tree[k] for k in tree)
    assert calls == [(3, 20), (3, 7)]
    for k in ("a", "c"):
        shf.bucketed_apply_collective_blocked(want[k].view(3, -1), plan[k],
                                              mesh)
    for k in tree:
        assert torch.equal(tree[k], want[k])
