"""The port's optimizers and LR schedule against the JAX package.

One SGD step and two AdamW steps (the second exercises the bias
correction at step 2) on the same float32 params, grads and state from
numpy, and ``cosine_lr`` over warmup and decay: within 1e-6 (the same
float32 arithmetic; XLA may fuse a multiply-add or take ``cos``/``pow``
within an ulp).  The port updates in place, over flat chunks: chunking
changes no number (bitwise), and the step counter of a stacked state is
advanced through a member's view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.core import population as pop
from repro_torch.optim import optimizers as topt

TOL = dict(rtol=1e-6, atol=1e-6)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (7, 5)}, "b": (11,), "c": [(3, 2, 4)]}

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = pop.tree_map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = pop.tree_map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))
    return params, grads


def _t(tree):
    return pop.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    for g, w in zip(pop.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_sgd_step_matches_jax():
    params, grads = _trees(0)
    jstate = jopt.sgd_init(params)
    jstate = {"mu": jax.tree_util.tree_map(lambda x: x * 0.3, params),
              "step": jstate["step"]}
    want_p, want_s = jopt.sgd_update(params, grads, jstate, 0.05,
                                     momentum=0.9, weight_decay=1e-4)
    tp, tstate = _t(params), topt.sgd_init(_t(params))
    tstate["mu"] = _t(jstate["mu"])
    got_p, got_s = topt.sgd_update(tp, _t(grads), tstate, 0.05)
    assert got_p is tp and got_s is tstate
    _close(got_p, want_p)
    _close(got_s["mu"], want_s["mu"])
    assert int(got_s["step"]) == int(want_s["step"]) == 1


def test_adamw_two_steps_match_jax():
    params, grads = _trees(1)
    _, grads2 = _trees(2)
    jp, js = params, jopt.adamw_init(params)
    tp, ts = _t(params), topt.adamw_init(_t(params))
    for g in (grads, grads2):
        jp, js = jopt.adamw_update(jp, g, js, 3e-3)
        topt.adamw_update(tp, _t(g), ts, 3e-3)
    _close(tp, jp)
    _close(ts["mu"], js["mu"])
    _close(ts["nu"], js["nu"])
    assert int(ts["step"]) == 2


def test_cosine_lr_matches_jax():
    for step in range(0, 31):
        for warmup in (0, 5):
            got = topt.cosine_lr(step, 30, 0.1, 1e-4, warmup)
            want = float(jopt.cosine_lr(step, 30, 0.1, 1e-4, warmup))
            np.testing.assert_allclose(got, want, **TOL)
            assert isinstance(got, float)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_chunked_update_is_bitwise_the_whole_leaf_update(name, monkeypatch):
    params, grads = _trees(3)
    init, update = topt.make_optimizer(name, weight_decay=0.01)
    whole_p, whole_s = _t(params), init(_t(params))
    update(whole_p, _t(grads), whole_s, 0.01)
    monkeypatch.setattr(topt, "CHUNK", 4)
    part_p, part_s = _t(params), init(_t(params))
    update(part_p, _t(grads), part_s, 0.01)
    for a, b in zip(pop.tree_leaves(whole_p) + pop.tree_leaves(whole_s["mu"]),
                    pop.tree_leaves(part_p) + pop.tree_leaves(part_s["mu"])):
        assert torch.equal(a, b)


def test_member_views_update_a_stacked_state_in_place():
    params, grads = _trees(4)
    stacked = pop.replicate(_t(params), 3)
    state = topt.sgd_init(stacked)
    state["step"] = torch.zeros(3, dtype=torch.int32)
    before = pop.tree_map(torch.clone, stacked)
    topt.sgd_update(pop.member(stacked, 1), _t(grads), pop.member(state, 1), 0.1)
    assert state["step"].tolist() == [0, 1, 0]
    for b, a in zip(pop.tree_leaves(before), pop.tree_leaves(stacked)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
        assert not torch.equal(a[1], b[1])


def test_bf16_params_keep_their_dtype_with_f32_moments():
    params, grads = _trees(5)
    tp = pop.tree_map(lambda a: torch.from_numpy(a).bfloat16(), params)
    state = topt.sgd_init(tp)
    topt.sgd_update(tp, pop.tree_map(torch.from_numpy, grads), state, 0.1)
    assert all(x.dtype == torch.bfloat16 for x in pop.tree_leaves(tp))
    assert all(m.dtype == torch.float32 for m in pop.tree_leaves(state["mu"]))
    jp, _ = jopt.sgd_update(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        grads, jopt.sgd_init(params), 0.1)
    for g, w in zip(pop.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2 ** -8,
                                   atol=0)  # at most one bf16 rounding apart


def test_make_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="optimizer"):
        topt.make_optimizer("lion")
