"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the same weights and inputs.

Weights are drawn by the JAX package and carried across as numpy; the
inputs come from a seeded numpy generator.  Float32 throughout: outputs
and the router's aux loss within 1e-5, gradients (of a weighted sum of
the output plus the aux loss, to the weights and the input) within 1e-4.
A capacity far below the load drops the same assignments on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import moe as JMOE
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as TMOE
from repro_torch.train.interop import params_from_numpy

KW = dict(d_model=16, moe=True, n_routed_experts=4, top_k=2, moe_d_ff=8,
          dtype="float32")


def _setup(shared=1, **extra):
    kw = dict(KW, n_shared_experts=shared, **extra)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = JMOE.moe_init(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("impl,B", [("global", 3), ("grouped", 3),
                                    ("grouped", 1)],
                         ids=["global", "grouped", "grouped-B1"])
def test_dispatch_matches_jax(impl, B, shared):
    jcfg, tcfg, jp, tp = _setup(shared, moe_impl=impl)
    x = _x((B, 12, 16))
    jout, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    tout, taux = TMOE.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    assert taux.dtype == torch.float32 and tp["router"].dtype == torch.float32


def test_capacity_drops_the_same_assignments():
    """Capacity factor 0.01 (the reference's ``test_models`` case): most
    assignments overflow their expert's 8 rows; the same tokens come out
    residual-only (exactly zero) on both sides, and the rest agree."""
    jcfg, tcfg, jp, tp = _setup(0, capacity_factor=0.01)
    x = _x((4, 64, 16), seed=1)
    jout = np.asarray(JMOE.moe_apply(jp, jcfg, jnp.asarray(x))[0])
    tout = TMOE.moe_apply(tp, tcfg, torch.from_numpy(x))[0].numpy()
    jzero = np.all(jout == 0.0, axis=-1)
    np.testing.assert_array_equal(np.all(tout == 0.0, axis=-1), jzero)
    assert jzero.mean() > 0.5
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)


def test_gradients_match_jax():
    jcfg, tcfg, jp, tp = _setup(1)
    x = _x((2, 10, 16), seed=2)
    g = _x((2, 10, 16), seed=3)

    def jloss(p, xx):
        out, aux = JMOE.moe_apply(p, jcfg, xx)
        return jnp.sum(out * g) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TMOE.moe_apply(tp, tcfg, tx)
    (torch.sum(out * torch.from_numpy(g)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jgp)[0]:
        leaf = tp
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jleaf),
                                   rtol=1e-4, atol=1e-4, err_msg=str(path))


def test_same_output_on_two_runs():
    _, tcfg, _, tp = _setup(1)
    x = torch.from_numpy(_x((3, 16, 16), seed=4))
    a, aux_a = TMOE.moe_apply(tp, tcfg, x)
    b, aux_b = TMOE.moe_apply(tp, tcfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_init_matches_the_reference_tree():
    """The layer's tree, shapes and dtypes (the router float32 in a bf16
    model), drawn with and without destination leaves alike."""
    kw = dict(KW, n_shared_experts=2, dtype="bfloat16")
    want = jax.tree_util.tree_map(
        lambda x: ((3,) + x.shape, str(x.dtype)),
        JMOE.moe_init(jax.random.key(0), JaxConfig(**kw)))
    cfg = ModelConfig(**kw)
    gen = torch.Generator().manual_seed(5)
    p = TMOE.moe_init(gen, cfg, lead=(3,))
    got = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")), p)
    assert got == want
    meta = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
        TMOE.moe_shapes(cfg, 3))
    assert meta == want
    dst = {k: torch.empty_like(v) for k, v in p["experts"].items()}
    q = TMOE.moe_init(torch.Generator().manual_seed(5), cfg, lead=(3,),
                      experts=dst)
    for k in dst:
        assert q["experts"][k] is dst[k]
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)):
        assert torch.equal(a, b)
