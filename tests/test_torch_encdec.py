"""The last model families against the JAX package: whisper-medium's
encoder-decoder over audio frames and internvl2-76b's vision patch
prefix, at ``reduced()`` size, float32, on JAX weights carried across by
``params_from_numpy`` and JAX's frames and patches as numpy.

Tolerances, each with its reason: ``forward_logits``, ``loss_fn`` and
every gradient within 1e-4 (float32 matmuls and softmax sums in two
frameworks, through the encoder, the cross-attention and the backward);
the prefill's logits and its whole cache (the decoder's ring and the
cross-attention's ``xk`` / ``xv``) within 1e-5 (a forward only); the
layers ``gelu_mlp`` and ``xattn`` within 1e-5; greedy tokens equal, token
for token, through the scan engine in member, soup and ensemble modes;
layer depths and checkpoint leaves exactly equal.  Also the train and
serve CLIs end to end at ``--reduced`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import layer_index as JLI
from repro.models import layers as JL
from repro.models import transformer as JM
from repro.serving import engine as jengine
from repro.train import checkpoint as JC
from repro_torch.configs import get_arch
from repro_torch.core import layer_index as TLI
from repro_torch.core import population as pop
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TM
from repro_torch.serving import engine
from repro_torch.train import checkpoint as TC
from repro_torch.train.interop import params_from_numpy

ARCHS = ["whisper-medium", "internvl2-76b"]
# JAX's weights come from a key of this generator: quicker to compile
# than threefry, and the weights cross to the port as data all the same
KEY_IMPL = "unsafe_rbg"
EXTRA = {"whisper-medium": ("frames", "num_frames"),
         "internvl2-76b": ("patches", "num_patches")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: one intra-op thread each (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_POPS = {}


def _setup(arch):
    """(jax cfg, port cfg, jax population, port population), N = 2."""
    if arch not in _POPS:
        jcfg, tcfg = jax_arch(arch).reduced(), get_arch(arch).reduced()
        jpop = jax.jit(jax.vmap(lambda k: JM.init_params(k, jcfg)))(
            jax.random.split(jax.random.key(3, impl=KEY_IMPL), 2))
        tpop = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                                 device="cpu")
        _POPS[arch] = (jcfg, tcfg, jpop, tpop)
    return _POPS[arch]


def _member(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _batch(cfg, B, S, seed):
    """Tokens and the frontend's input as numpy: ``(jax batch, port
    batch)``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    key, n = EXTRA[cfg.name.replace("-reduced", "")]
    b[key] = rng.standard_normal((B, getattr(cfg, n), cfg.d_model)).astype(
        np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol, err_msg=what)


def test_gelu_mlp_and_xattn_match_jax():
    """The encoder's MLP (jax.nn.gelu's tanh form) and the decoder's
    cross-attention (queries of length 5 over 11 encoder positions, GQA
    group 2) on the same weights and inputs."""
    jcfg = jax_arch("whisper-medium").reduced(num_kv_heads=2)
    tcfg = get_arch("whisper-medium").reduced(num_kv_heads=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32) * 2
    enc = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    jp = JL.gelu_mlp_init(jax.random.key(1, impl=KEY_IMPL), jcfg.d_model,
                          jcfg.d_ff, jnp.float32)
    jp = dict(jp, b1=jnp.asarray(rng.standard_normal(jcfg.d_ff), jnp.float32),
              b2=jnp.asarray(rng.standard_normal(jcfg.d_model), jnp.float32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    _close(TL.gelu_mlp(tp, torch.from_numpy(x)),
           jax.jit(JL.gelu_mlp)(jp, jnp.asarray(x)), 1e-5, "gelu_mlp")
    jp = JL.xattn_init(jax.random.key(2, impl=KEY_IMPL), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    _close(TL.xattn(tp, tcfg, torch.from_numpy(x), torch.from_numpy(enc)),
           jax.jit(lambda p, x, e: JL.xattn(p, jcfg, x, e))(
               jp, jnp.asarray(x), jnp.asarray(enc)), 1e-5,
           "xattn")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jpop, tpop = _setup(arch)
    jp, tp = _member(jpop, 0), _member(tpop, 0)
    jb, tb = _batch(tcfg, 2, 12, 1)
    (jloss, jlog), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (JM.loss_fn(p, jcfg, jb)[0],
                   JM.forward_logits(p, jcfg, jb)[0]), has_aux=True))(jp)
    tlog, _ = TM.forward_logits(tp, tcfg, tb)
    assert tlog.shape == (2, 12, tcfg.vocab_size)
    _close(tlog, jlog, 1e-4, "logits")
    leaves = [x.clone().requires_grad_() for x in pop.tree_leaves(tp)]
    it = iter(leaves)
    tp = pop.tree_map(lambda _: next(it), tp)
    tloss, _ = TM.loss_fn(tp, tcfg, tb)
    _close(tloss, jloss, 1e-4, "loss")
    tgrads = torch.autograd.grad(tloss, leaves)
    paths = [p for p, _ in pop.tree_paths(tp)]
    for path, g, w in zip(paths, tgrads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, w, 1e-4, str(path))
    assert float(max(g.abs().max() for g in tgrads)) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    """The prefill's last-position logits and every leaf of its cache,
    ``xk`` / ``xv`` and the ring behind the patch prefix included."""
    jcfg, tcfg, jpop, tpop = _setup(arch)
    jb, tb = _batch(tcfg, 2, 9, 2)
    cap = engine.internal_prefix(tcfg) + 9 + 4
    jlog, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, capacity=cap))(
        _member(jpop, 1), jb)
    tlog, tcache = TM.prefill(_member(tpop, 1), tcfg, tb, capacity=cap)
    _close(tlog, jlog, 1e-5, "prefill logits")
    flat = jax.tree_util.tree_leaves(jcache)
    paths = list(pop.tree_paths(tcache))
    assert len(paths) == len(flat)
    for (path, t), j in zip(paths, flat):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
    assert ("xk",) in dict(paths) or not tcfg.is_encdec


@pytest.mark.parametrize("mode", ["member", "soup", "ensemble"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scan_engine_greedy_tokens_match_jax(arch, mode):
    jcfg, tcfg, jpop, tpop = _setup(arch)
    jb, tb = _batch(tcfg, 3, 7, 3)
    want = jengine.generate_from_population(jpop, jcfg, jb, 6, mode=mode,
                                            member=1)
    got = engine.generate_from_population(tpop, tcfg, tb, 6, mode=mode,
                                          member=1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_takes_exactly_num_frames():
    _, tcfg, _, tpop = _setup("whisper-medium")
    _, tb = _batch(tcfg, 1, 4, 4)
    tb["frames"] = tb["frames"][:, :-1]
    with pytest.raises(ValueError, match="num_frames"):
        TM.forward_logits(_member(tpop, 0), tcfg, tb)


@pytest.mark.parametrize("encoder_layers", [2, 3], ids=["equal", "unequal"])
def test_layer_ids_match_jax(encoder_layers):
    """The encoder's blocks get the depths 1..L only when
    ``encoder_layers == num_layers``; otherwise the head's depth, as the
    reference's rule gives (under the decreasing schedule they never
    shuffle)."""
    jcfg = jax_arch("whisper-medium").reduced(encoder_layers=encoder_layers)
    tcfg = get_arch("whisper-medium").reduced(encoder_layers=encoder_layers)
    want = JLI.infer_layer_ids(
        jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg)),
        jcfg.num_layers)
    got = TLI.infer_layer_ids(TM.param_shapes(tcfg), tcfg.num_layers)
    flat = jax.tree_util.tree_leaves(want)
    paths = list(pop.tree_paths(got))
    assert len(paths) == len(flat)
    for (path, g), w in zip(paths, flat):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(path))
    enc = dict(paths)[("enc_blocks", "attn", "wq")]
    assert (np.array_equal(enc, [1, 2]) if encoder_layers == 2
            else enc == TLI.total_layers(tcfg.num_layers) - 1)


def test_jax_checkpoint_restores_bitwise_and_serves_jax_tokens(tmp_path):
    """A reduced float32 whisper population saved by
    ``repro.train.checkpoint`` restores in the port bitwise and serves
    JAX's greedy tokens (ensemble)."""
    jcfg, tcfg, jpop, _ = _setup("whisper-medium")
    path = str(tmp_path / "whisper.npz")
    JC.save(path, jpop)
    like = pop.tree_map(lambda x: x.unsqueeze(0).expand((2,) + x.shape),
                        TM.param_shapes(tcfg))
    back = TC.restore(path, like, device="cpu")
    for (p, t), j in zip(pop.tree_paths(back),
                         jax.tree_util.tree_leaves(jpop)):
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      np.asarray(j).view(np.uint32),
                                      err_msg=str(p))
    jb, tb = _batch(tcfg, 3, 7, 3)
    want = jengine.generate(jpop, jcfg, jb, 6, mode="ensemble")
    got = engine.generate(back, tcfg, tb, 6, mode="ensemble", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_serve_clis_on_the_cpu(arch, tmp_path):
    """The train CLI (bucketed WASH, its batches carrying the frontend's
    input) into ``--ckpt-population``, then the serve CLI's scan engine
    from that file in every mode."""
    ckpt = str(tmp_path / "pop.npz")
    res = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--population", "2", "--mode", "bucketed",
                          "--base-p", "0.3", "--steps", "2", "--batch-size",
                          "1", "--seq-len", "8", "--ckpt-population", ckpt])
    assert np.isfinite(res.history["loss"]).all()
    assert res.history["comm"][-1] > 0
    outs = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--population", "2", "--ckpt", ckpt,
                           "--batch-size", "2", "--seq-len", "6",
                           "--max-new", "3", "--compare"])
    assert list(outs) == ["member", "ensemble", "soup"]
    for out in outs.values():
        assert out["tokens"].shape == (2, 9)


def test_train_cli_trains_the_config_it_is_given(capsys):
    """``main(argv, cfg=...)`` trains the given cut of ``--arch`` (here the
    reduced deepseek-v2-lite-16b at one layer), on the flags' settings."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(),
                              num_layers=1)
    res = train_cli.main(["--arch", "deepseek-v2-lite-16b", "--device",
                          "cpu", "--population", "2", "--mode", "bucketed",
                          "--base-p", "0.3", "--steps", "2", "--batch-size",
                          "1", "--seq-len", "8", "--record-every", "1"],
                         cfg=cfg)
    assert len(res.history["loss"]) == 2
    assert np.isfinite(res.history["loss"]).all()
    shapes = pop.tree_map(lambda m: (2,) + tuple(m.shape),
                          TM.param_shapes(cfg))
    got = pop.tree_map(lambda x: tuple(x.shape), res.population)
    assert got == shapes
    assert f"arch={cfg.name}" in capsys.readouterr().out
