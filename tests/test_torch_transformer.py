"""The port's paged prefill and decode (``repro_torch.models.transformer``)
against ``repro.models.transformer`` on JAX weights carried across by
``params_from_numpy``.

Two slots share one pool: slot A's prompt is prefilled in two chunks (the
second at a mid-page offset), slot B's in one, then three decode steps
run both slots at different depths.  Logits agree within 1e-4 (float32
matmuls in two frameworks).  Pools: fp32 pools within 1e-5; int8 pools
hold bits that may differ by one step where a K/V value lands on a
rounding boundary, so they are compared dequantized, within one page
scale, with the scales themselves within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import layers as JL
from repro.models import transformer as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TM
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50, dtype="float32")
NUM_PAGES, PAGE = 12, 4


def _params(jcfg):
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _check_pools(tp, jp):
    for side in ("k", "v"):
        t, j = tp[side], jp[side]
        if isinstance(j, dict):
            js, ts = np.asarray(j["scale"]), t["scale"].numpy()
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
            jd = np.asarray(j["q"], np.float32) * js[:, :, None, None, None]
            td = t["q"].numpy().astype(np.float32) * ts[:, :, None, None, None]
            step = np.maximum(js, ts)[:, :, None, None, None]
            assert np.all(np.abs(td - jd) <= step * (1 + 1e-5)), side
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True, "qk_norm": True}],
                         ids=["llama", "bias_qknorm"])
def test_prefill_and_decode_track_jax(kv_dtype, extra):
    jcfg, tcfg = JaxConfig(**CFG_KW, **extra), ModelConfig(**CFG_KW, **extra)
    jparams, tparams = _params(jcfg)
    jpools = JL.paged_pools_init(jcfg, NUM_PAGES, PAGE, jcfg.num_layers,
                                 kv_dtype=kv_dtype)
    tpools = TL.paged_pools_init(tcfg, NUM_PAGES, PAGE, tcfg.num_layers,
                                 kv_dtype=kv_dtype, device="cpu")
    rng = np.random.default_rng(1)
    prompts = {"A": rng.integers(0, 50, 10).astype(np.int32),
               "B": rng.integers(0, 50, 5).astype(np.int32)}
    tables = {"A": np.array([1, 2, 3, 4], np.int32),
              "B": np.array([5, 6, 7, 8], np.int32)}
    chunks = [("A", 0, 7), ("B", 0, 5), ("A", 7, 3)]
    last = {}
    for slot, pos0, T in chunks:
        toks = prompts[slot][pos0:pos0 + T]
        jl, jpools = JM.prefill_paged(jparams, jcfg, jnp.asarray(toks), pos0,
                                      jpools, jnp.asarray(tables[slot]))
        tl, tpools = TM.prefill_paged(tparams, tcfg, torch.from_numpy(toks),
                                      pos0, tpools,
                                      torch.from_numpy(tables[slot]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        _check_pools(tpools, jpools)
        last[slot] = int(np.argmax(np.asarray(jl)[0, -1]))

    pt = np.stack([tables["A"], tables["B"]])
    positions = np.array([10, 5], np.int32)
    tokens = np.array([last["A"], last["B"]], np.int32)
    for _ in range(3):
        jl, jpools = JM.decode_step_paged(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jpools, jnp.asarray(pt))
        tl, tpools = TM.decode_step_paged(
            tparams, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tpools, torch.from_numpy(pt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        _check_pools(tpools, jpools)
        tokens = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)
        positions = positions + 1


def test_init_params_matches_the_reference_tree():
    """Same paths, shapes and dtypes as the JAX init; ``param_shapes``
    gives the same tree on the meta device."""
    jcfg = JaxConfig(**CFG_KW, qkv_bias=True)
    tcfg = ModelConfig(**CFG_KW, qkv_bias=True)
    want = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)),
                                  JM.init_params(jax.random.key(0), jcfg))
    for tree in (TM.init_params(tcfg, seed=0, device="cpu"),
                 TM.param_shapes(tcfg)):
        got = jax.tree_util.tree_map(
            lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
            tree)
        assert got == want


def test_unported_configs_are_rejected():
    """whisper's encoder-decoder and internvl2's patch prefix build in the
    reference's tree (``init_params`` and ``param_shapes``); what neither
    package runs is refused: an encoder-decoder of MoE blocks, an rwkv6
    model behind a patch prefix."""
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch

    for arch in ("internvl2-76b", "whisper-medium"):
        jcfg, tcfg = jax_arch(arch).reduced(), get_arch(arch).reduced()
        want = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)),
                                      JM.init_params(jax.random.key(0), jcfg))
        for tree in (TM.init_params(tcfg, seed=0, device="cpu"),
                     TM.param_shapes(tcfg)):
            got = jax.tree_util.tree_map(
                lambda x: (tuple(x.shape),
                           str(x.dtype).replace("torch.", "")), tree)
            assert got == want, arch
    whisper = get_arch("whisper-medium").reduced()
    for cfg in (dataclasses.replace(whisper, moe=True, n_routed_experts=4,
                                    top_k=2),
                get_arch("rwkv6-3b").reduced(frontend="vision",
                                              num_patches=4)):
        with pytest.raises(NotImplementedError):
            TM.init_params(cfg, device="cpu")
