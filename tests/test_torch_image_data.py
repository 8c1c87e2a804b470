"""The port's image task and augmentations (``repro_torch.data``) against
``repro.data``.  The port draws from its own seeds, so JAX's draws are
handed across as data where numbers are compared.

Tolerances, each with its reason:
* the prototype smoothing on JAX's raw draw within 1e-6 (nine float32
  products summed in another order);
* ``apply_policy`` on JAX's draws: images bitwise (selection, and
  elementwise float32 math with the same float32 weights in the same
  order), soft labels within 1e-6, each row summing to 1 within 1e-6;
* ``soft_cross_entropy`` within 1e-6.
The port's own draws are held to the reference's contracts: shapes,
ranges, determinism, statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import augment as JA
from repro.data import synthetic as JS
from repro_torch.core.prng import fold_in
from repro_torch.data import augment as TA
from repro_torch.data import synthetic as TS

B, HW = 16, 12


def _jax_draw(key, policy, b, h, w):
    """The draws ``repro.data.augment.apply_policy`` makes from ``key``,
    as the port's :class:`AugmentDraw`."""
    _, k_cut, k_er, k_perm, k_lam = jax.random.split(key, 5)
    as_t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    kw = {"perm": as_t(jax.random.permutation(k_perm, b))}
    if policy.mixup > 0:
        kw["mix_lam"] = float(jax.random.beta(k_lam, policy.mixup,
                                              policy.mixup, ()))
    if policy.cutmix > 0:
        kw["cut_lam"] = float(jax.random.beta(k_cut, policy.cutmix,
                                              policy.cutmix, ()))
        kw["cut_cy"] = int(jax.random.randint(k_cut, (), 0, h))
        kw["cut_cx"] = int(jax.random.randint(jax.random.fold_in(k_cut, 1),
                                              (), 0, w))
    if policy.erase > 0:
        eh = max(int(policy.erase * h), 1)
        kw["erase_y"] = as_t(jax.random.randint(k_er, (b,), 0, h - eh + 1))
        kw["erase_x"] = as_t(jax.random.randint(jax.random.fold_in(k_er, 1),
                                                (b,), 0, w - eh + 1))
    return TA.AugmentDraw(**kw)


# each menu's corners alone, then all of them at once
POLICIES = [(0.0, 0.0, 0.0, 0.0), (0.5, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0),
            (0.0, 0.05, 0.0, 0.0), (0.0, 0.1, 0.0, 0.0), (0.0, 0.0, 0.5, 0.0),
            (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.15),
            (0.0, 0.0, 0.0, 0.35), (1.0, 0.1, 1.0, 0.35),
            (0.5, 0.05, 0.5, 0.15)]


@pytest.mark.parametrize("shape", [(HW, HW), (10, 13)])
@pytest.mark.parametrize("policy", POLICIES,
                         ids=["-".join(map(str, p)) for p in POLICIES])
def test_apply_policy_on_jax_draws_matches_jax(policy, shape):
    h, w = shape
    rng = np.random.default_rng(hash(policy) % 1000)
    for seed in range(6):
        x = rng.standard_normal((B, h, w, 3)).astype(np.float32)
        labels = rng.integers(0, 10, B).astype(np.int32)
        key = jax.random.key(seed)
        jpol = JA.AugmentPolicy(*policy)
        ji, jy = JA.apply_policy(key, jnp.asarray(x), jnp.asarray(labels), 10,
                                 jpol)
        ti, ty = TA.apply_draw(torch.from_numpy(x), torch.from_numpy(labels),
                               10, TA.AugmentPolicy(*policy),
                               _jax_draw(key, jpol, B, h, w))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ty.sum(-1).numpy(), np.ones(B), atol=1e-6)


@pytest.mark.parametrize("policy", POLICIES[1:],
                         ids=["-".join(map(str, p)) for p in POLICIES[1:]])
def test_own_draws_hold_the_reference_contract(policy):
    pol = TA.AugmentPolicy(*policy)
    x = torch.randn(B, HW, HW, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.arange(B) % 10
    draw = TA.draw_augment(5, pol, B, HW, HW, "cpu")
    again = TA.draw_augment(5, pol, B, HW, HW, "cpu")
    for f in ("perm", "erase_y", "erase_x"):
        a, b = getattr(draw, f), getattr(again, f)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert (draw.mix_lam, draw.cut_lam, draw.cut_cy, draw.cut_cx) == (
        again.mix_lam, again.cut_lam, again.cut_cy, again.cut_cx)
    if pol.mixup > 0 or pol.cutmix > 0:
        assert sorted(draw.perm.tolist()) == list(range(B))
    if pol.mixup > 0:
        assert 0.0 <= draw.mix_lam <= 1.0
        assert draw.mix_lam == float(np.float32(draw.mix_lam))
    if pol.cutmix > 0:
        assert 0.0 <= draw.cut_lam <= 1.0
        assert 0 <= draw.cut_cy < HW and 0 <= draw.cut_cx < HW
    if pol.erase > 0:
        side = TA.erase_side(pol, HW)
        for corner in (draw.erase_y, draw.erase_x):
            assert corner.shape == (B,) and corner.dtype == torch.int64
            assert int(corner.min()) >= 0 and int(corner.max()) <= HW - side
    xi, y = TA.apply_policy(5, x, labels, 10, pol)
    xd, yd = TA.apply_draw(x, labels, 10, pol, draw)
    assert torch.equal(xi, xd) and torch.equal(y, yd)
    assert xi.shape == x.shape and y.shape == (B, 10)
    torch.testing.assert_close(y.sum(-1), torch.ones(B))
    if pol.erase > 0 and pol.mixup == 0 and pol.cutmix == 0:
        side = TA.erase_side(pol, HW)
        assert int((xi == 0).all(-1).sum()) == B * side * side


def test_beta_weights_follow_their_distribution():
    """Beta(a, a) has mean 1/2 and variance 1 / (4 (2a + 1))."""
    for a in (0.5, 1.0):
        pol = TA.AugmentPolicy(mixup=a)
        lams = np.array([TA.draw_augment(s, pol, 2, 4, 4, "cpu").mix_lam
                         for s in range(4000)])
        assert abs(lams.mean() - 0.5) < 0.02
        assert abs(lams.var() - 1 / (4 * (2 * a + 1))) < 0.01


def test_policies_come_from_the_menus():
    pols = TA.member_policies(3, 200, True)
    assert pols == TA.member_policies(3, 200, True)
    for field, menu in (("mixup", TA.MIXUP_MENU), ("smooth", TA.SMOOTH_MENU),
                        ("cutmix", TA.CUTMIX_MENU), ("erase", TA.ERASE_MENU)):
        assert menu == getattr(JA, field.upper() + "_MENU")
        seen = {getattr(p, field) for p in pols}
        assert seen == set(menu), field
    assert TA.member_policies(3, 4, False) == [TA.AugmentPolicy()] * 4
    assert TA.draw_policy(fold_in(3, 1)) == pols[1]


def test_prototype_smoothing_matches_jax_on_its_raw_draw():
    key = jax.random.key(4)
    for hw in (10, 12, 16):
        raw = np.array(jax.random.normal(key, (10, hw, hw, 3)) * 0.8)
        want = np.asarray(JS.make_image_task(key, 10, hw).prototypes)
        got = TS.smooth_prototypes(torch.from_numpy(raw))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_image_task_draws_hold_the_reference_contract():
    task = TS.make_image_task(1, num_classes=10, hw=HW, noise=1.6,
                              device="cpu")
    assert task.prototypes.shape == (10, HW, HW, 3)
    assert task.num_classes == 10 and task.noise == 1.6
    assert torch.equal(task.prototypes, TS.make_image_task(
        1, 10, HW, 1.6, device="cpu").prototypes)
    # smoothed N(0, 0.8^2): interior pixels have variance 0.64 / 9
    inner = task.prototypes[:, 1:-1, 1:-1]
    assert abs(float(inner.var()) / (0.64 / 9) - 1) < 0.1
    x, y = TS.sample_images(task, 7, 4096)
    assert x.shape == (4096, HW, HW, 3) and x.dtype == torch.float32
    assert y.dtype == torch.int64 and set(y.tolist()) == set(range(10))
    noise = x - task.prototypes[y]
    assert abs(float(noise.std()) / 1.6 - 1) < 0.01
    assert abs(float(noise.mean())) < 0.01
    ex, ey = TS.eval_images(task, 7, 4096)
    assert torch.equal(ex, x) and torch.equal(ey, y)
    assert not torch.equal(TS.sample_images(task, 8, 16)[0], x[:16])


def test_soft_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((9, 10)) * 4).astype(np.float32)
    y = rng.dirichlet(np.ones(10), 9).astype(np.float32)
    want = float(JA.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(y)))
    got = TA.soft_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-6)
