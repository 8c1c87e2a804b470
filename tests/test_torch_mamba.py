"""The port's hybrid family against the JAX package on the CPU: the Mamba
path (``repro_torch.models.ssm``: the causal depthwise conv, prefill from
zero and from a carried state, decode), banded sliding-window attention
(``sdpa_banded``), the hybrid block, and whole reduced hymba-1.5b
(``loss_fn`` and its grads, prefill and decode logits and caches, greedy
tokens through the scan engine), on JAX's weights carried across with
``train.interop.params_from_numpy``; and the full-width parameter tree,
shapes only.  Three WASH training steps against the JAX loop are in
``test_torch_hymba_train.py``.

Tolerances, each with its reason: forward values within 1e-5 (float32
matmuls and the state sums in another order in each framework); grads
within 1e-4 (float32 sums through 2 layers); greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models import transformer as JM
from repro.serving import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.core import population as pop
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TM
from repro_torch.serving import engine
from repro_torch.train.interop import params_from_numpy

ARCH = "hymba-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores, and spinning thread pools slow them a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    """The reduced hymba (2 layers, window 64, 16 states) at d_model 64:
    d_inner 128, dt_rank 4."""
    kw = {"d_model": 64, **kw}
    return jax_arch(ARCH).reduced(**kw), get_arch(ARCH).reduced(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _mamba(jcfg, seed):
    """JAX's mamba params with ``conv_b``, ``D`` and ``A_log`` moved off
    their init (zeros, ones and log 1..S would hide them)."""
    rng = np.random.default_rng(seed)
    p = _np(JSSM.mamba_init(jax.random.key(seed), jcfg))
    DI, S = jcfg.d_inner, jcfg.ssm_state
    p["conv_b"] = (0.1 * rng.standard_normal(DI)).astype(np.float32)
    p["D"] = (1 + 0.2 * rng.standard_normal(DI)).astype(np.float32)
    p["A_log"] = (p["A_log"] + 0.1 * rng.standard_normal((DI, S))
                  ).astype(np.float32)
    return p


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((B, cfg.d_inner, cfg.ssm_state))
            .astype(np.float32),
            "conv": rng.standard_normal((B, cfg.ssm_conv - 1, cfg.d_inner))
            .astype(np.float32)}


def _assert_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   err_msg=key, **tol)


def test_causal_depthwise_conv_with_left_context_matches_jax():
    jcfg, tcfg = _configs()
    p = _mamba(jcfg, 0)
    rng = np.random.default_rng(1)
    xz = rng.standard_normal((2, 9, jcfg.d_inner)).astype(np.float32)
    prev = rng.standard_normal((2, jcfg.ssm_conv - 1, jcfg.d_inner)
                               ).astype(np.float32)
    jout, jprev = JSSM._causal_depthwise_conv(_jtree(p), jcfg,
                                              jnp.asarray(xz),
                                              jnp.asarray(prev))
    tout, tprev = TSSM._causal_depthwise_conv(
        params_from_numpy(p, "cpu"), tcfg, torch.from_numpy(xz),
        torch.from_numpy(prev))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("T", [1, 13], ids=["one", "thirteen"])
def test_mamba_prefill_matches_jax(carried, T):
    jcfg, tcfg = _configs()
    p = _mamba(jcfg, 2)
    state = _state(jcfg, 2, 3)
    if not carried:
        state = {k: np.zeros_like(v) for k, v in state.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, T, jcfg.d_model)).astype(np.float32)
    jout, jstate = JSSM.mamba_prefill(_jtree(p), jcfg, jnp.asarray(x),
                                      _jtree(state))
    tout, tstate = TSSM.mamba_prefill(params_from_numpy(p, "cpu"), tcfg,
                                      torch.from_numpy(x),
                                      params_from_numpy(state, "cpu"))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _assert_tree({k: v.numpy() for k, v in tstate.items()}, jstate)


def test_mamba_decode_matches_jax_and_leaves_its_state_unwritten():
    jcfg, tcfg = _configs()
    p = _mamba(jcfg, 5)
    state = _state(jcfg, 3, 6)
    x = np.random.default_rng(7).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    jout, jstate = JSSM.mamba_decode(_jtree(p), jcfg, jnp.asarray(x),
                                     _jtree(state))
    tstate_in = params_from_numpy(state, "cpu")
    before = pop.tree_map(torch.clone, tstate_in)
    tout, tstate = TSSM.mamba_decode(params_from_numpy(p, "cpu"), tcfg,
                                     torch.from_numpy(x), tstate_in)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _assert_tree({k: v.numpy() for k, v in tstate.items()}, jstate)
    assert all(torch.equal(a, b) for a, b in zip(
        pop.tree_leaves(before), pop.tree_leaves(tstate_in)))


def test_mamba_train_is_prefill_from_zero_with_no_state():
    jcfg, tcfg = _configs()
    p = params_from_numpy(_mamba(jcfg, 8), "cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32))
    zero = TSSM.mamba_state_init(tcfg, 2, 1, device="cpu")
    want, _ = TSSM.mamba_prefill(p, tcfg, x, pop.tree_map(lambda t: t[0],
                                                          zero))
    out, state = TSSM.mamba_prefill(p, tcfg, x, None)
    assert state is None and torch.equal(out, want)
    assert torch.equal(TSSM.mamba_train(p, tcfg, x), want)


def test_state_init_matches_the_reference():
    jcfg, tcfg = _configs(dtype="bfloat16")
    want = JSSM.mamba_state_init(jcfg, 3, 2)
    got = TSSM.mamba_state_init(tcfg, 3, 2, device="cpu")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).replace("torch.", "") == str(
            want[key].dtype)
        assert not got[key].any()


@pytest.mark.parametrize("S,W", [(8, 4), (12, 4), (16, 8)])
def test_sdpa_banded_matches_jax(S, W):
    rng = np.random.default_rng(S + W)
    q = rng.standard_normal((2, S, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = JL.sdpa_banded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                          window=W)
    got = TL.sdpa_banded(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), 2, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the band is the windowed causal softmax
    mask = TL.causal_mask(S, W)
    plain = TL.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), mask, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def _model(jcfg, seed=0):
    jp = JM.init_params(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("variant", [{}, {"attn_impl": "chunked"},
                                     {"remat_blocks": True}],
                         ids=["naive", "chunked-banded", "remat"])
def test_loss_and_grads_match_jax(variant):
    """The whole reduced hymba (2 layers, window 64): the loss within
    1e-5, every grad within 1e-4.  ``attn_impl="chunked"`` at 128 tokens
    (a multiple of the window, longer than it) trains the attention
    through ``sdpa_banded``, as the reference does."""
    jcfg, tcfg = _configs(**variant)
    T = 128 if variant.get("attn_impl") == "chunked" else 24
    jp, tp = _model(jcfg)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, T)).astype(np.int32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jp)
    leaves = [x.requires_grad_() for x in pop.tree_leaves(tp)]
    tloss, _ = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    paths = [path for path, _ in pop.tree_paths(tp)]
    for path, g, w in zip(paths, grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(path),
                                   **GRAD_TOL)
    named = dict(zip(paths, grads))
    for leaf in (("mamba", "A_log"), ("mamba", "x_proj"), ("beta",)):
        assert named[("blocks",) + leaf].abs().max() > 0, leaf


def test_chunked_attention_trains_through_the_banded_form(monkeypatch):
    """Two WASH steps of the reduced hymba with ``attn_impl="chunked"`` at
    128 tokens, a multiple of the 64-token window and longer than it:
    every layer's training attention takes ``sdpa_banded`` (held to JAX
    above), the losses are finite and the params move."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.train import loop as tloop

    _, tcfg = _configs(attn_impl="chunked")
    calls, banded = [], TL.sdpa_banded

    def spy(*args, **kwargs):
        calls.append(kwargs["window"])
        return banded(*args, **kwargs)

    monkeypatch.setattr(TL, "sdpa_banded", spy)
    init = TM.init_params(tcfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 128)))
    res = tloop.train_population(
        0, lambda s: pop.tree_map(torch.clone, init),
        lambda p, b: TM.loss_fn(p, tcfg, b)[0],
        lambda m, s, seed: {"tokens": tokens},
        TrainConfig(population=2, lr=0.05, total_steps=2),
        MixingConfig(kind="wash", base_p=0.3, mode="bucketed"),
        tcfg.num_layers, record_every=1, device="cpu")
    # at least 2 members x 2 steps x 2 layers
    assert calls and set(calls) == {64}
    assert len(calls) >= 2 * 2 * tcfg.num_layers
    assert np.isfinite(res.history["loss"]).all()
    moved = pop.tree_leaves(pop.member(res.population, 0))
    assert any(not torch.equal(a, b) for a, b in zip(
        moved, pop.tree_leaves(init)))


def test_hybrid_block_matches_jax():
    jcfg, tcfg = _configs()
    jp, tp = _model(jcfg, seed=2)
    blk_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    blk_j["beta"] = jnp.asarray([0.3, 1.2], jnp.float32)
    blk_t = params_from_numpy(_np(blk_j), "cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 10, jcfg.d_model)).astype(np.float32)
    state = jax.tree_util.tree_map(lambda a: a[0],
                                   JSSM.mamba_state_init(jcfg, 2, 1))
    jx, _, _ = JM._block_train(blk_j, jcfg, jnp.asarray(x), state)
    tx, aux = TM._block_train(blk_t, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_logits_and_caches_match_jax():
    """Prefill 20 tokens (the window of 64 not yet full) into a capacity
    of 24, then three decode steps: the logits, the windowed ring (k, v,
    pos_ids) and every layer's Mamba ``h`` and ``conv``."""
    jcfg, tcfg = _configs()
    jp, tp = _model(jcfg, seed=4)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jlg, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                         capacity=24)
    tlg, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                         capacity=24)
    assert set(tc) == set(jc) == {"kv", "ssm"}

    def same(tlg, tc, jlg, jc):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        for (path, g), w in zip(pop.tree_paths(tc),
                                jax.tree_util.tree_leaves(jc)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=str(path), **TOL)

    same(tlg, tc, jlg, jc)
    nxt = np.asarray(jlg[:, -1].argmax(-1)).astype(np.int32)
    for i in range(3):
        jlg, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt[:, None]), jc,
                                 20 + i)
        tlg, tc = TM.decode_step(tp, tcfg, torch.from_numpy(nxt[:, None]),
                                 tc, 20 + i)
        same(tlg, tc, jlg, jc)
        nxt = np.asarray(jlg[:, -1].argmax(-1)).astype(np.int32)


@pytest.fixture
def _fresh_engine():
    engine.reset_trace_counts()
    engine.clear_executable_cache()
    yield
    engine.clear_executable_cache()


@pytest.mark.parametrize("mode", ["soup", "member", "ensemble"])
def test_greedy_tokens_match_jax_generate(mode, _fresh_engine):
    """The scan engine carries the ``"ssm"`` cache in every mode (the
    ensemble's stacked one too); the prompt of 70 overruns the 64-token
    window's ring."""
    jcfg, tcfg = _configs()
    jpop = jax.vmap(lambda k: JM.init_params(k, jcfg))(
        jax.random.split(jax.random.key(6), 2))
    tpop = params_from_numpy(_np(jpop), "cpu")
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 70)).astype(np.int32)
    want = jengine.generate_from_population(
        jpop, jcfg, {"tokens": jnp.asarray(prompts)}, 6, mode=mode, member=1)
    got = engine.generate_from_population(
        tpop, tcfg, {"tokens": torch.from_numpy(prompts)}, 6, mode=mode,
        member=1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_shapes_match_jax_at_full_width():
    """hymba-1.5b at full width (32 layers, d_model 1600, d_inner 3200,
    dt_rank 100): the tree of shapes and dtypes, nothing materialised on
    either side (``jax.eval_shape``; ``meta`` tensors)."""
    jcfg, tcfg = jax_arch(ARCH), get_arch(ARCH)
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg)))
    shapes = TM.param_shapes(tcfg)
    got = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
        shapes)
    assert got == want
    assert all(x.device.type == "meta" for x in pop.tree_leaves(shapes))
    assert shapes["blocks"]["mamba"]["dt_proj"].shape == (32, 100, 3200)
    assert shapes["blocks"]["mamba"]["A_log"].dtype == torch.float32


def test_init_tree_matches_the_reference_in_bf16():
    jcfg, tcfg = _configs(dtype="bfloat16")
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg)))
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    got = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")), tp)
    assert got == want
    m = tp["blocks"]["mamba"]
    S = tcfg.ssm_state
    assert torch.equal(m["A_log"][1, 5], torch.log(torch.arange(1.0, S + 1)))
    assert torch.equal(tp["blocks"]["beta"], torch.ones(2, 2))
    assert (m["dt_bias"] == -2).all() and (m["D"] == 1).all()


def test_jax_hybrid_tree_carries_across_unchanged():
    """``train.interop`` carries the JAX hybrid tree (``mamba.*``, ``beta``;
    bf16 with float32 ``A_log``, ``D`` and ``beta``) into the port: the
    same paths, dtypes and bits."""
    jcfg, _ = _configs(dtype="bfloat16")
    jp = _np(JM.init_params(jax.random.key(8), jcfg))
    tp = params_from_numpy(jp, "cpu")
    jpaths = [tuple(getattr(k, "key", k) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [path for path, _ in pop.tree_paths(tp)] == jpaths
    for t, a in zip(pop.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))
    assert tp["blocks"]["mamba"]["A_log"].dtype == torch.float32
    assert tp["blocks"]["beta"].dtype == torch.float32
