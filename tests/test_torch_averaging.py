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
