"""The port's RWKV-6 block (``repro_torch.models.ssm``) against
``repro.models.ssm`` on JAX weights carried across, and the rwkv6
parameter tree across the two packages' checkpoints.

The block runs from a non-zero carried state (WKV state and both token
shifts), with the decay base ``w0`` and the bonus ``u`` made non-zero (the
reference's init leaves both at 0, which would hide them).  Outputs and
every leaf of the new state agree within 1e-4 in float32 (matmuls and the
recurrence sum in another order in each framework), and so do the block's
grads (its vjp, the WKV recurrence's part by ``ops.rwkv6_scan``'s
backward).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import ModelConfig as JaxConfig
from repro.models import ssm as JSSM
from repro.models import transformer as JM
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core import population as pop
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.interop import params_from_numpy

CFG_KW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
              d_ff=96, vocab_size=50, block_kind="rwkv6", rwkv_head_dim=16,
              dtype="float32")


def _block_inputs(cfg, seed, B, T):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        np.asarray, JSSM.rwkv6_init(jax.random.key(seed), JaxConfig(**CFG_KW)))
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    p["tm"]["w0"] = (0.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    p["tm"]["u"] = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    norms = {"ln1": {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model))
                     .astype(np.float32)},
             "ln2": {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model))
                     .astype(np.float32)}}
    state = {"S": rng.standard_normal((B, H, hd, hd)).astype(np.float32),
             "x_tm": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
             "x_cm": rng.standard_normal((B, cfg.d_model)).astype(np.float32)}
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return p, norms, state, x


@pytest.mark.parametrize("B,T", [(2, 12), (3, 1)], ids=["prefill", "decode"])
def test_block_from_a_carried_state_matches_jax(B, T):
    jcfg, tcfg = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
    p, norms, state, x = _block_inputs(tcfg, B * 10 + T, B, T)
    jtree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jx, jstate = JSSM.rwkv6_block(jtree(p), jcfg, jnp.asarray(x),
                                  jtree(state), jtree(norms))
    tt = lambda t: params_from_numpy(t, device="cpu")  # noqa: E731
    tx, tstate = TSSM.rwkv6_block(tt(p), tcfg, torch.from_numpy(x),
                                  tt(state), tt(norms))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    assert set(tstate) == set(jstate) == {"S", "x_tm", "x_cm"}
    for key in tstate:
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("T", [12, 37], ids=["one-chunk", "ragged"])
def test_block_grads_match_jax_vjp(T):
    """The block's vjp from a carried state, with cotangents on its output
    and on every leaf of its new state (the final WKV state's grad among
    them): the grads of every param (the decay's ``w0`` / ``w_lora_*``
    through exp(-exp(w_dd)), the bonus ``u``), of the input and of the
    carried state, within 1e-4 of JAX's (float32; the WKV recurrence's
    grads through ``ops.rwkv6_scan``'s backward, where JAX differentiates
    its scan)."""
    jcfg, tcfg = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
    p, norms, state, x = _block_inputs(tcfg, T, 2, T)
    rng = np.random.default_rng(T + 1)
    dx = rng.standard_normal(x.shape).astype(np.float32)
    dstate = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in state.items()}
    jtree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    _, vjp = jax.vjp(lambda *a: JSSM.rwkv6_block(a[0], jcfg, a[1], a[2],
                                                  a[3]),
                     jtree(p), jnp.asarray(x), jtree(state), jtree(norms))
    want = vjp((jnp.asarray(dx), jtree(dstate)))
    tt = lambda t: params_from_numpy(t, device="cpu")  # noqa: E731
    args = [tt(p), torch.from_numpy(x), tt(state), tt(norms)]
    leaves = [t.requires_grad_() for t in pop.tree_leaves(args)]
    tx, tstate = TSSM.rwkv6_block(args[0], tcfg, args[1], args[2], args[3])
    cot = [torch.from_numpy(dx)] + [torch.from_numpy(dstate[k])
                                    for k in tstate]
    got = torch.autograd.grad([tx] + [tstate[k] for k in tstate], leaves,
                              grad_outputs=cot)
    paths = [p_ for p_, _ in pop.tree_paths(args)]
    for path, g, w in zip(paths, got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    tm = dict(zip(paths, got))
    for leaf in ("w0", "w_lora_a", "w_lora_b", "u"):
        assert tm[(0, "tm", leaf)].abs().max() > 0, leaf


def test_block_leaves_its_input_state_unwritten():
    tcfg = ModelConfig(**CFG_KW)
    p, norms, state, x = _block_inputs(tcfg, 4, 2, 5)
    tt = lambda t: params_from_numpy(t, device="cpu")  # noqa: E731
    tstate = tt(state)
    before = pop.tree_map(torch.clone, tstate)
    TSSM.rwkv6_block(tt(p), tcfg, torch.from_numpy(x), tstate, tt(norms))
    for a, b in zip(pop.tree_leaves(before), pop.tree_leaves(tstate)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(dtype):
    """Same paths, shapes and dtypes as the JAX init (``tm.w0`` and
    ``tm.u`` float32 in both, the rest in the param dtype);
    ``param_shapes`` gives the same tree on the meta device."""
    jcfg = JaxConfig(**{**CFG_KW, "dtype": dtype})
    tcfg = ModelConfig(**{**CFG_KW, "dtype": dtype})
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg)))
    for tree in (TM.init_params(tcfg, seed=0, device="cpu"),
                 TM.param_shapes(tcfg)):
        got = jax.tree_util.tree_map(
            lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
            tree)
        assert got == want


def test_state_init_matches_the_reference():
    jcfg, tcfg = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
    want = JSSM.rwkv_state_init(jcfg, 3, 2)
    got = TSSM.rwkv_state_init(tcfg, 3, 2, device="cpu")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).replace("torch.", "") == str(
            want[key].dtype)
        assert not got[key].any()


def _like(cfg, n):
    return pop.tree_map(lambda x: x.unsqueeze(0).expand((n,) + x.shape),
                        TM.param_shapes(cfg))


def test_jax_bf16_rwkv6_population_restores_bitwise(tmp_path):
    """A JAX population file of the reduced rwkv6-3b in bf16 (its ``w0``
    and ``u`` leaves float32) restores in the port bit for bit."""
    jcfg = jax_arch("rwkv6-3b").reduced(dtype="bfloat16")
    tcfg = get_arch("rwkv6-3b").reduced(dtype="bfloat16")
    jpop = jax.vmap(lambda k: JM.init_params(k, jcfg))(
        jax.random.split(jax.random.key(1), 2))
    path = str(tmp_path / "pop.npz")
    jckpt.save(path, jpop)
    back = tckpt.restore(path, _like(tcfg, 2), device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(jpop)[0])
    jleaves = {tuple(getattr(k, "key", k) for k in path_): np.asarray(v)
               for path_, v in flat.items()}
    seen = set()
    for path_, leaf in pop.tree_paths(back):
        want = jleaves[tuple(path_)]
        if want.dtype == ml_dtypes.bfloat16:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy(), want)
        seen.add(str(leaf.dtype))
    assert seen == {"torch.bfloat16", "torch.float32"}


def test_port_rwkv6_population_restores_in_jax(tmp_path):
    """The reverse, in float32 (the JAX ``restore`` cannot read a bf16
    leaf: ROADMAP §3)."""
    jcfg = jax_arch("rwkv6-3b").reduced()
    tcfg = get_arch("rwkv6-3b").reduced()
    tpop = pop.stack([TM.init_params(tcfg, seed=s, device="cpu")
                      for s in (0, 1)])
    path = tckpt.save(str(tmp_path / "pop"), tpop)
    like = jax.eval_shape(lambda: jax.vmap(lambda k: JM.init_params(k, jcfg))(
        jax.random.split(jax.random.key(0), 2)))
    back = jckpt.restore(path, like)
    got = jax.tree_util.tree_leaves(back)
    want = pop.tree_leaves(tpop)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
