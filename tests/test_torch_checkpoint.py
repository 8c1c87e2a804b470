"""Checkpoints across the two packages: a population ``.npz`` written by
``repro.train.checkpoint.save`` restores in the port bitwise (f32 and
bf16), the port's ``save`` is read back by JAX, and the soup of the
restored population is bitwise the JAX soup.

The JAX ``restore`` cannot read a bfloat16 leaf back from ``np.load``
(``|V2`` has no cast to bfloat16), so the JAX side of the bf16 round trip
is read with ``np.load`` and viewed as ``ml_dtypes.bfloat16``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.core import averaging as JA
from repro.models import transformer as JM
from repro.train import checkpoint as JC
from repro_torch.configs.base import ModelConfig
from repro_torch.core import averaging as TA
from repro_torch.core import population as pop
from repro_torch.models import transformer as TM
from repro_torch.train import checkpoint as TC
from repro_torch.train.interop import params_from_numpy, params_to_numpy

CFG_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=50)
N = 3


def _jax_population(dtype):
    cfg = JaxConfig(**CFG_KW, dtype=dtype)
    keys = jax.random.split(jax.random.key(0), N)
    return jax.vmap(lambda k: JM.init_params(k, cfg))(keys)


def _like(dtype):
    shapes = TM.param_shapes(ModelConfig(**CFG_KW, dtype=dtype))
    return pop.tree_map(lambda x: x.unsqueeze(0).expand((N,) + x.shape),
                        shapes)


def _bits(x):
    """A leaf's raw bits, for bitwise comparison across dtypes."""
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _assert_tree_bitwise(torch_tree, jax_tree):
    flat_t = dict(pop.tree_paths(params_to_numpy(torch_tree)))
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        key = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        np.testing.assert_array_equal(_bits(flat_t[key]), _bits(leaf),
                                      err_msg=str(key))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_population_restores_bitwise_and_soups_agree(dtype, tmp_path):
    jpop = _jax_population(dtype)
    path = JC.save(str(tmp_path / "pop"), jpop)
    tpop = TC.restore(path, _like(dtype), device="cpu")
    assert all(x.dtype == getattr(torch, dtype)
               for x in pop.tree_leaves(tpop))
    _assert_tree_bitwise(tpop, jpop)
    _assert_tree_bitwise(TA.uniform_soup(tpop), JA.uniform_soup(jpop))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_reads_back_in_jax(dtype, tmp_path):
    jpop = _jax_population(dtype)
    tpop = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                             device="cpu")
    path = TC.save(str(tmp_path / "port"), tpop)
    if dtype == "float32":
        back = JC.restore(path, jpop)
    else:
        with np.load(path) as data:
            back = {k: data[k].view(ml_dtypes.bfloat16) for k in data}
        back = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(back["::".join(
                str(p.key) if hasattr(p, "key") else str(p.idx)
                for p in path)]), jpop)
    _assert_tree_bitwise(tpop, back)
    # the port's archive holds the same keys and raw bytes as JAX's
    jpath = JC.save(str(tmp_path / "jax"), jpop)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_restore_checks_shapes_and_needs_a_device_for_meta(tmp_path):
    path = JC.save(str(tmp_path / "pop"), _jax_population("float32"))
    like = _like("float32")
    with pytest.raises(ValueError, match="device"):
        TC.restore(path, like)
    bad = pop.tree_map(lambda x: x[:2], like)
    with pytest.raises(ValueError, match="!="):
        TC.restore(path, bad, device="cpu")


def test_jax_deepseek_population_restores_with_mixed_dtypes(tmp_path):
    """A JAX-written bf16 population of the reduced DeepSeek-V2-Lite (MLA
    attention, MoE MLP, a float32 router in a bf16 model) restores into
    the port bitwise, every leaf in the reference's dtype, and serves
    through the scan engine; ``params_from_numpy`` keeps the same
    dtypes."""
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch
    from repro_torch.serving import engine

    jcfg = jax_arch("deepseek-v2-lite-16b").reduced(dtype="bfloat16")
    tcfg = get_arch("deepseek-v2-lite-16b").reduced(dtype="bfloat16")
    jpop = jax.vmap(lambda k: JM.init_params(k, jcfg))(
        jax.random.split(jax.random.key(4), 2))
    path = JC.save(str(tmp_path / "deepseek"), jpop)
    like = pop.tree_map(lambda x: x.unsqueeze(0).expand((2,) + x.shape),
                        TM.param_shapes(tcfg))
    tpop = TC.restore(path, like, device="cpu")
    _assert_tree_bitwise(tpop, jpop)
    router = tpop["blocks"]["mlp"]["router"]
    assert router.dtype == torch.float32
    assert tpop["blocks"]["mlp"]["experts"]["w1"].dtype == torch.bfloat16
    assert tpop["blocks"]["attn"]["w_dkv"].dtype == torch.bfloat16
    cast = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                             device="cpu")
    assert ([x.dtype for x in pop.tree_leaves(cast)]
            == [x.dtype for x in pop.tree_leaves(tpop)])
    prompts = torch.randint(0, tcfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(0))
    out = engine.generate_from_population(tpop, tcfg, {"tokens": prompts},
                                          3, mode="ensemble", device="cpu")
    assert out.shape == (2, 9) and torch.equal(out[:, :6], prompts.int())
