"""The port's classifiers (``repro_torch.models.cnn``) against
``repro.models.cnn``, with JAX's weights carried across as numpy.

Tolerances, each with its reason:
* logits within 1e-5 (float32 convolutions, GroupNorm reductions and
  matmuls summed in another order by two frameworks);
* the gradients of ``soft_cross_entropy ∘ apply_classifier`` within 1e-4
  of ``jax.grad`` (the same, through the backward pass);
* ``conv`` alone within 1e-5, which also holds XLA's ``"SAME"`` padding
  at stride 2 on even sizes (pad (0, 1)) and odd ones (pad (1, 1));
* the init: the reference's tree paths, shapes and dtypes exactly; its
  scales as a statistical check (the draws are not ``jax.random``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layer_index import infer_layer_ids as jinfer_layer_ids
from repro.data import augment as JAUG
from repro.models import cnn as J
from repro_torch.core import layer_index as tli
from repro_torch.core import population as pop
from repro_torch.data import augment as TAUG
from repro_torch.models import cnn as T
from repro_torch.train.interop import params_from_numpy

KINDS = ("mlp", "resnet", "vgg")


def _configs(**kw):
    return J.ClassifierConfig(**kw), T.ClassifierConfig(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(hw, b=5, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("hw", [10, 12, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_classifier_matches_jax(kind, hw, depth, groups):
    jcfg, tcfg = _configs(kind=kind, width=8, depth=depth, image_hw=hw,
                          groups=groups)
    jparams = J.init_classifier(jax.random.key(hw + depth), jcfg)
    x = _images(hw)
    want = np.asarray(J.apply_classifier(jparams, jcfg, jnp.asarray(x)))
    got = T.apply_classifier(params_from_numpy(_np(jparams), "cpu"), tcfg,
                             torch.from_numpy(x))
    assert got.shape == (5, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [10, 12])
@pytest.mark.parametrize("kind", KINDS)
def test_loss_gradients_match_jax(kind, hw):
    jcfg, tcfg = _configs(kind=kind, width=8, depth=3, image_hw=hw)
    jparams = J.init_classifier(jax.random.key(7), jcfg)
    x = _images(hw, b=6, seed=1)
    y = np.random.default_rng(2).dirichlet(np.ones(10), 6).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: JAUG.soft_cross_entropy(
        J.apply_classifier(p, jcfg, jnp.asarray(x)), jnp.asarray(y)))(jparams)
    tparams = params_from_numpy(_np(jparams), "cpu")
    leaves = [t.requires_grad_() for t in pop.tree_leaves(tparams)]
    tloss = TAUG.soft_cross_entropy(
        T.apply_classifier(tparams, tcfg, torch.from_numpy(x)),
        torch.from_numpy(y))
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [(9, 9), (10, 10), (11, 12), (12, 7)])
def test_conv_same_padding_matches_xla(size, stride, k):
    rng = np.random.default_rng(size[0] * 10 + size[1])
    x = rng.standard_normal((2,) + size + (3,)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(J.conv(jnp.asarray(w), jnp.asarray(x), stride))
    got = T.conv(torch.from_numpy(w), torch.from_numpy(x), stride)
    assert got.shape == want.shape == (2, -(-size[0] // stride),
                                       -(-size[1] // stride), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,k,stride,pads", [
    (12, 3, 2, (0, 1)), (10, 3, 2, (0, 1)), (5, 3, 2, (1, 1)),
    (12, 1, 2, (0, 0)), (5, 1, 2, (0, 0)), (12, 3, 1, (1, 1))])
def test_same_pads_are_xlas(size, k, stride, pads):
    assert T._same_pads(size, k, stride) == pads


@pytest.mark.parametrize("groups", [1, 2, 4, 64])
def test_groupnorm_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((3, 5, 4, 8)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    want = np.asarray(J.groupnorm(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x), groups))
    got = T.groupnorm(params_from_numpy(p, "cpu"), torch.from_numpy(x), groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_init_has_the_reference_tree_and_layer_ids(kind, depth):
    jcfg, tcfg = _configs(kind=kind, width=8, depth=depth, image_hw=8)
    jparams = J.init_classifier(jax.random.key(0), jcfg)
    tparams = T.init_classifier(0, tcfg, device="cpu")
    jpaths = [(tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path),
               tuple(leaf.shape), str(leaf.dtype))
              for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)]
    tpaths = [(path, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
              for path, leaf in pop.tree_paths(tparams)]
    assert tpaths == jpaths
    assert (jax.tree_util.tree_leaves(jinfer_layer_ids(jparams, depth))
            == pop.tree_leaves(tli.infer_layer_ids(tparams, depth)))
    again = T.init_classifier(0, tcfg, device="cpu")
    other = T.init_classifier(1, tcfg, device="cpu")
    for a, b, c in zip(*(pop.tree_leaves(t) for t in (tparams, again, other))):
        assert torch.equal(a, b)
        if a.abs().sum() > 0 and not torch.all(a == 1):
            assert not torch.equal(a, c)


@pytest.mark.parametrize("kind", ["resnet", "vgg"])
def test_init_scales_follow_the_reference(kind):
    """conv N(0, 2 / (k k cin)), dense N(0, 1 / cin), zero biases, GroupNorm
    ones and zeros: the sample std of each big leaf within 5% of its
    scale, its mean within 4 standard errors of 0."""
    cfg = T.ClassifierConfig(kind=kind, width=32, depth=3, image_hw=8)
    params = T.init_classifier(3, cfg, device="cpu")
    for path, leaf in pop.tree_paths(params):
        name = path[-1]
        if name in ("bias", "b"):
            assert torch.all(leaf == 0), path
        elif name == "scale":
            assert torch.all(leaf == 1), path
        else:
            fan = leaf.shape[0] * leaf.shape[1] * leaf.shape[2] \
                if leaf.dim() == 4 else leaf.shape[0]
            want = (2.0 / fan) ** 0.5 if leaf.dim() == 4 else fan ** -0.5
            if leaf.numel() >= 2000:
                std = float(leaf.std())
                assert abs(std / want - 1) < 0.05, (path, std, want)
                assert abs(float(leaf.mean())) < 4 * want / leaf.numel() ** 0.5


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="kind"):
        T.init_classifier(0, T.ClassifierConfig(kind="vit"), device="cpu")
