"""The port's soups (``repro_torch.core.averaging``) against
``repro.core.averaging``: the same fixed pairwise-sum tree and one divide,
so the results are held bitwise in float32 for N = 1..5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as JA
from repro_torch.core import averaging as TA
from repro_torch.core import population as pop


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_balanced_mean_bitwise(n):
    x = np.random.default_rng(n).standard_normal((n, 7, 3)).astype(np.float32)
    got = TA.balanced_mean(torch.from_numpy(x)).numpy()
    want = np.asarray(JA.balanced_mean(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_uniform_soup_bitwise_over_a_nested_tree(n):
    rng = np.random.default_rng(10 + n)
    tree = {"embed": {"tok": rng.standard_normal((n, 6, 4))},
            "blocks": [{"w": rng.standard_normal((n, 2, 4, 4))},
                       {"w": rng.standard_normal((n, 2, 4))}],
            "head": rng.standard_normal((n, 4)) * 1e3}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    got = TA.uniform_soup(pop.tree_map(torch.from_numpy, tree))
    want = JA.uniform_soup(jax.tree_util.tree_map(jnp.asarray, tree))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(g.numpy(), np.asarray(w)),
        got, want)


def test_population_helpers_round_trip():
    members = [{"a": torch.full((2,), float(i)), "b": [torch.ones(3) * i]}
               for i in range(3)]
    stacked = pop.stack(members)
    assert pop.population_size(stacked) == 3
    assert pop.num_params(members[0]) == 5
    for i, m in enumerate(pop.unstack(stacked)):
        assert torch.equal(m["a"], members[i]["a"])
        assert torch.equal(pop.member(stacked, i)["b"][0], members[i]["b"][0])
    rep = pop.replicate(members[1], 4)
    assert rep["a"].shape == (4, 2) and torch.equal(rep["a"][3],
                                                    members[1]["a"])
    rep["a"][0, 0] = 9.0  # replicate copies: members stay independent
    assert float(rep["a"][1, 0]) == 1.0


# ---------------------------------------------------------------------------
# the evaluation strategies on classifier populations
#
# Tolerances: ensemble log-probs, ``soup_of`` and ``interpolate`` within
# 1e-6 (float32 softmax sums and means in another order); accuracies
# within 1e-6, i.e. the same count of right answers (argmax of logits
# that agree to ~1e-7; the count over B is divided in float32 in either
# package's own way); GreedySoup the same members, so the same soup
# within 1e-6.
# ---------------------------------------------------------------------------

from repro.core.population import init_population as jinit_population
from repro.models import cnn as JC
from repro_torch.models import cnn as TC
from repro_torch.train.interop import params_from_numpy

CCFG = dict(kind="mlp", width=16, depth=2, image_hw=6)


def _classifier_population(n, seed=3, dup=None):
    """n independently initialized JAX members (member ``dup[1]`` a copy
    of ``dup[0]`` when given), a batch, and labels that member 0 gets
    right on half the batch and the rest get right by chance."""
    jcfg = JC.ClassifierConfig(**CCFG)
    jpop = jinit_population(lambda k: JC.init_classifier(k, jcfg),
                            jax.random.key(seed), n, same_init=False)
    jpop = jax.tree_util.tree_map(np.array, jpop)
    if dup is not None:
        for leaf in jax.tree_util.tree_leaves(jpop):
            leaf[dup[1]] = leaf[dup[0]]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((96, 6, 6, 3)).astype(np.float32)
    teacher = np.asarray(JC.apply_classifier(
        jax.tree_util.tree_map(lambda a: a[0], jpop), jcfg, x)).argmax(-1)
    labels = np.where(rng.random(96) < 0.5, teacher,
                      rng.integers(0, 10, 96)).astype(np.int32)
    jfn = lambda p, b: JC.apply_classifier(p, jcfg, b)
    tcfg = TC.ClassifierConfig(**CCFG)
    tfn = lambda p, b: TC.apply_classifier(p, tcfg, b)
    return (jpop, params_from_numpy(jpop, "cpu"), x, labels, jfn, tfn)


def _assert_trees_close(got, want, tol):
    for g, w in zip(pop.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_ensemble_and_accuracies_match_jax(n):
    jpop, tpop, x, y, jfn, tfn = _classifier_population(n)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        TA.ensemble_logprobs(tfn, tpop, tx).numpy(),
        np.asarray(JA.ensemble_logprobs(jfn, jpop, x)), rtol=1e-6, atol=1e-6)
    same_count = dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        float(TA.ensemble_accuracy(tfn, tpop, tx, ty)),
        float(JA.ensemble_accuracy(jfn, jpop, x, y)), **same_count)
    accs = TA.member_accuracies(tfn, tpop, tx, ty)
    assert accs.shape == (n,) and accs.dtype == torch.float32
    np.testing.assert_allclose(accs.numpy(), np.asarray(
        JA.member_accuracies(jfn, jpop, x, y)), **same_count)
    soup = TA.uniform_soup(tpop)
    np.testing.assert_allclose(
        float(TA.model_accuracy(tfn, soup, tx, ty)),
        float(JA.model_accuracy(jfn, JA.uniform_soup(jpop), x, y)),
        **same_count)


@pytest.mark.parametrize("indices", [[0], [2, 0], [1, 2, 3], [3, 3, 1]])
def test_soup_of_and_interpolate_match_jax(indices):
    jpop, tpop, *_ = _classifier_population(4)
    _assert_trees_close(TA.soup_of(tpop, indices), JA.soup_of(jpop, indices),
                        1e-6)
    weights = [1.0 + i * (k + 1) for k, i in enumerate(range(4))]
    weights = [w if k in indices else 0.0 for k, w in enumerate(weights)]
    _assert_trees_close(TA.interpolate(tpop, weights),
                        JA.interpolate(jpop, weights), 1e-6)
    with pytest.raises(ValueError, match="weights"):
        TA.interpolate(tpop, [1.0, 2.0])


@pytest.mark.parametrize("n,seed,dup", [(3, 3, None), (4, 5, None),
                                        (4, 3, (0, 2)), (5, 7, (1, 4))])
def test_greedy_soup_chooses_the_members_jax_chooses(n, seed, dup):
    """The same members in the same order: a stable descending sort of
    the accuracies (a duplicated member ties and keeps its place) and
    ``>=`` to take one."""
    jpop, tpop, x, y, jfn, tfn = _classifier_population(n, seed, dup)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    chosen = TA.greedy_soup_members(tfn, tpop, tx, ty)
    accs = np.asarray(JA.member_accuracies(jfn, jpop, x, y))
    order = list(np.argsort(-accs, kind="stable"))
    assert chosen[0] == order[0] and len(set(chosen)) == len(chosen)
    assert [i for i in order if i in chosen] == chosen
    want = JA.greedy_soup(jfn, jpop, x, y)
    _assert_trees_close(TA.greedy_soup(tfn, tpop, tx, ty), want, 1e-6)
    _assert_trees_close(TA.soup_of(tpop, chosen), want, 1e-6)


# ---------------------------------------------------------------------------
# the population drawn in place and the soup made in place (the serve
# CLI's route at full width, where neither a second model nor a whole
# member beside the population fits the card)
# ---------------------------------------------------------------------------


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("arch,dtype", [
    ("deepseek-v2-lite-16b", "bfloat16"), ("kimi-k2-1t-a32b", "float32"),
    ("llama3.2-3b", "bfloat16"), ("rwkv6-3b", "float32")])
def test_population_is_drawn_in_place_as_members_are(arch, dtype):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import init_population
    from repro_torch.models import transformer as TM

    cfg = get_arch(arch).reduced(dtype=dtype)
    popn = init_population(cfg, 3, seed=2, device="cpu")
    for i in range(3):
        want = TM.init_params(cfg, seed=2 * 1000 + i, device="cpu")
        got = pop.member(popn, i)
        assert [p for p, _ in pop.tree_paths(got)] == \
            [p for p, _ in pop.tree_paths(want)]
        assert all(_bitwise(a, b) for a, b in zip(pop.tree_leaves(got),
                                                  pop.tree_leaves(want)))
    if cfg.moe:
        assert popn["blocks"]["mlp"]["router"].dtype == torch.float32


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_in_place_soup_is_bitwise_the_soup(n, dtype, monkeypatch):
    """Leaves above the slice size are averaged a slice of their second
    axis at a time; every leaf comes out bitwise ``uniform_soup``'s."""
    monkeypatch.setattr(TA, "SOUP_SLICE_BYTES", 64)
    gen = torch.Generator().manual_seed(n)
    tree = {"embed": torch.randn(n, 30, 4, generator=gen).to(dtype),
            "blocks": {"w": torch.randn(n, 5, 3, 4, generator=gen).to(dtype),
                       "v": torch.randn(n, 5, generator=gen).to(dtype)},
            "head": (torch.randn(n, 4, generator=gen) * 1e3).to(dtype)}
    want = TA.uniform_soup(tree)
    got = TA.uniform_soup_(tree)
    for g, w, x in zip(pop.tree_leaves(got), pop.tree_leaves(want),
                       pop.tree_leaves(tree)):
        assert _bitwise(g, w)
        assert g.data_ptr() == x.data_ptr()  # member 0's slot of the leaf


def test_serve_cli_soup_in_place_serves_the_soups_tokens(capsys):
    """``--compare`` serves member, ensemble, then the soup made in place
    from the population's memory: its tokens are those of the soup made
    beside it, for the reduced DeepSeek-V2-Lite on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.core.prng import fold_in
    from repro_torch.launch import serve
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import engine

    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    outs = serve.main(["--arch", cfg.name.replace("-reduced", ""),
                       "--reduced", "--device", "cpu", "--population", "2",
                       "--batch-size", "2", "--seq-len", "8", "--max-new",
                       "4", "--compare"])
    assert list(outs) == ["member", "ensemble", "soup"]
    popn = serve.init_population(cfg, 2, seed=0, device="cpu")
    batch = concrete_batch(cfg, fold_in(0, 2), 2, 8, device="cpu")
    want = engine.generate(TA.uniform_soup(popn), cfg, batch, 4,
                           device="cpu")
    assert torch.equal(outs["soup"]["tokens"], want)
    text = capsys.readouterr().out
    assert "prefill" in text and "decode step" in text
