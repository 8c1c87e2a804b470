"""The port's multi-head latent attention (``repro_torch.models.layers``
``mla_*``) against ``repro.models.layers`` on the same weights and inputs,
and the plain flash attention with values narrower than queries and keys
against the reference's ``flash_attention_ref``.

Float32: outputs and the latent cache within 1e-5, ``mla_train``'s
gradients within 1e-4 of ``jax.grad`` (float32 sums through the softmax
and its backward in two frameworks).  The port's ``mla_train`` writes the
masked softmax out in float32, as the reference does, so autograd
differentiates it on either device; ``mla_prefill`` attends through
``ops.flash_attention`` (its plain version on the CPU, the flash kernel
on the card); ``mla_decode`` keeps the reference's absorbed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TREF
from repro_torch.models import layers as TL
from repro_torch.train.interop import params_from_numpy

KW = dict(d_model=32, num_heads=4, num_kv_heads=4, mla=True, kv_lora_rank=16,
          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=8, dtype="float32")
JCFG, TCFG = JaxConfig(**KW), ModelConfig(**KW)
JP = JL.mla_init(jax.random.key(1), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), device="cpu")
T, CAP = 9, 12


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _layer(cache):
    return jax.tree_util.tree_map(lambda a: a[0], cache)


def test_train_matches_jax():
    x = _x((2, T, 32), 0)
    _close(TL.mla_train(TP, TCFG, torch.from_numpy(x)),
           JL.mla_train(JP, JCFG, jnp.asarray(x)))


def test_train_grads_match_jax():
    """The gradients of ``sum(mla_train(p, x) * dy)`` with respect to every
    weight and to ``x``."""
    x, dy = _x((2, T, 32), 5), _x((2, T, 32), 6)
    want = jax.jit(jax.grad(
        lambda p, x: jnp.sum(JL.mla_train(p, JCFG, x) * dy),
        argnums=(0, 1)))(JP, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in TP.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = TL.mla_train(tp, TCFG, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(),
                                [tp[k] for k in sorted(tp)] + [tx])
    for name, g in zip(sorted(tp), grads):
        _close(g, want[0][name], 1e-4)
    _close(grads[-1], want[1], 1e-4)


def test_prefill_then_decode_track_jax_and_the_full_forward():
    """Prefill T tokens into the latent cache, then decode three more: the
    outputs and the cache (ckv, krope, pos_ids) track the reference's at
    every step, and each decode output equals the full forward's last
    position over the same tokens."""
    B, n_dec = 2, 3
    x = _x((B, T + n_dec, 32), 1)
    jc = _layer(JL.mla_cache_init(JCFG, B, CAP, 1))
    tc = jax.tree_util.tree_map(lambda a: a[0],
                                TL.mla_cache_init(TCFG, B, CAP, 1,
                                                  device="cpu"))
    jout, jc = JL.mla_prefill(JP, JCFG, jnp.asarray(x[:, :T]), jc)
    tout, tc = TL.mla_prefill(TP, TCFG, torch.from_numpy(x[:, :T]), tc)
    _close(tout, jout)
    for name in ("ckv", "krope", "pos_ids"):
        _close(tc[name], jc[name])
    for i in range(n_dec):
        pos = T + i
        xt = x[:, pos:pos + 1]
        jout, jc = JL.mla_decode(JP, JCFG, jnp.asarray(xt), jc, pos)
        tout, tc = TL.mla_decode(TP, TCFG, torch.from_numpy(xt), tc, pos)
        _close(tout, jout)
        for name in ("ckv", "krope", "pos_ids"):
            _close(tc[name], jc[name])
        full = TL.mla_train(TP, TCFG, torch.from_numpy(x[:, :pos + 1]))
        _close(tout[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("hd,hd_v,H,KV", [(24, 8, 4, 4), (192, 128, 2, 1)],
                         ids=["mla-reduced", "mla-192x128-gqa"])
def test_plain_flash_with_narrow_values_matches_jax(hd, hd_v, H, KV):
    """The reference's ``flash_attention_ref`` takes one head width, so v
    is zero-padded to q's width there and its output cut back: attention
    is linear in v's columns."""
    B, S = 2, 11
    q, k = _x((B, S, H, hd), 2), _x((B, S, KV, hd), 3)
    v = _x((B, S, KV, hd_v), 4)
    vpad = np.concatenate([v, np.zeros((B, S, KV, hd - hd_v), np.float32)],
                          axis=-1)
    want = np.asarray(JREF.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vpad)))[..., :hd_v]
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    assert got.shape == (B, S, H, hd_v)
    _close(got, want)
    model = TREF.flash_attention_3xtf32_ref(torch.from_numpy(q),
                                            torch.from_numpy(k),
                                            torch.from_numpy(v))
    _close(model, want)
