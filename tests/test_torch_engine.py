"""The port's scan engine (``repro_torch.serving.engine``) against the JAX
package's ``repro.serving.engine`` on weights carried across.

Greedy tokens are held equal, token for token, to JAX ``generate`` for
the reduced float32 llama3.2-3b and rwkv6-3b in soup, member and ensemble
modes, and for a sliding-window config whose prompt or decode overruns
its ring.  The port's own contracts: ``generate`` equals the per-token
``generate_reference`` loop bitwise (greedy and sampled), sampled streams
depend on neither batch-mates nor ``max_new_tokens``, one program is built
per shape and reused, and rwkv6 trains (the plain WKV backward on the CPU;
on the card the train gate asks the backward kernel's head dims).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as JM
from repro.serving import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import population as pop
from repro_torch.core.mixing import MixingConfig
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TM
from repro_torch.serving import engine
from repro_torch.train import loop
from repro_torch.train.interop import params_from_numpy

ARCHS = ["llama3.2-3b", "rwkv6-3b"]


@pytest.fixture(autouse=True)
def _fresh_engine():
    engine.reset_trace_counts()
    engine.clear_executable_cache()
    yield
    engine.clear_executable_cache()


def _configs(arch, **overrides):
    return (jax_arch(arch).reduced(**overrides),
            get_arch(arch).reduced(**overrides))


def _populations(jcfg, n=2, seed=0):
    jpop = jax.vmap(lambda k: JM.init_params(k, jcfg))(
        jax.random.split(jax.random.key(seed), n))
    tpop = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                             device="cpu")
    return jpop, tpop


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _generate_both(jpop, tpop, jcfg, tcfg, prompts, max_new, mode, member=1):
    want = jengine.generate_from_population(
        jpop, jcfg, {"tokens": jnp.asarray(prompts)}, max_new, mode=mode,
        member=member)
    got = engine.generate_from_population(
        tpop, tcfg, {"tokens": torch.from_numpy(prompts)}, max_new,
        mode=mode, member=member, device="cpu")
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("mode", ["soup", "member", "ensemble"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_generate(arch, mode):
    jcfg, tcfg = _configs(arch)
    jpop, tpop = _populations(jcfg)
    prompts = _prompts(tcfg, 3, 9)
    want, got = _generate_both(jpop, tpop, jcfg, tcfg, prompts, 7, mode)
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got[:, :9], prompts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,S,max_new", [(4, 10, 5), (12, 8, 9)],
                         ids=["prompt_overruns_ring", "decode_wraps_ring"])
def test_sliding_window_ring_matches_jax(window, S, max_new):
    jcfg, tcfg = _configs("llama3.2-3b", window=window)
    jpop, tpop = _populations(jcfg, seed=3)
    prompts = _prompts(tcfg, 2, S, seed=window)
    want, got = _generate_both(jpop, tpop, jcfg, tcfg, prompts, max_new,
                               "soup")
    np.testing.assert_array_equal(got, want)
    cache = TM.init_cache(tcfg, 2, S + max_new, device="cpu")
    assert cache["kv"]["k"].shape[2] == min(window, S + max_new)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "temp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_the_reference_loop_bitwise(arch, temperature):
    _, tcfg = _configs(arch)
    params = TM.init_params(tcfg, seed=1, device="cpu")
    batch = {"tokens": torch.from_numpy(_prompts(tcfg, 2, 6))}
    seed = 7 if temperature > 0 else None
    ref = engine.generate_reference(params, tcfg, batch, 8,
                                    temperature=temperature, seed=seed,
                                    device="cpu")
    out = engine.generate(params, tcfg, batch, 8, temperature=temperature,
                          seed=seed, device="cpu")
    assert torch.equal(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_streams_are_per_request(arch):
    """A request's sampled stream depends on its own seed alone: not on
    its batch-mates, not on max_new_tokens; two requests with one prompt
    and different seeds draw different tokens; a seed is required."""
    _, tcfg = _configs(arch)
    params = TM.init_params(tcfg, seed=2, device="cpu")
    prompts = torch.from_numpy(_prompts(tcfg, 2, 5, seed=4))

    def sample(tokens, seeds, max_new):
        return engine.generate(params, tcfg, {"tokens": tokens}, max_new,
                               temperature=1.5, seed=seeds, device="cpu")

    both = sample(prompts, [11, 12], 24)
    alone = sample(prompts[:1], [11], 24)
    assert torch.equal(both[:1], alone)
    assert torch.equal(sample(prompts, [11, 12], 10), both[:, :5 + 10])
    twin = sample(prompts[:1].repeat(2, 1), [11, 12], 24)
    assert not torch.equal(twin[0], twin[1])
    assert torch.equal(sample(prompts, 5, 6), sample(prompts, 5, 6))
    with pytest.raises(ValueError, match="seed"):
        engine.generate(params, tcfg, {"tokens": prompts}, 4,
                        temperature=0.5, device="cpu")


def test_one_program_per_shape_reused():
    _, tcfg = _configs("rwkv6-3b")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_prompts(tcfg, 2, 5))}
    engine.generate(params, tcfg, batch, 16, device="cpu")
    assert engine.decode_trace_count() == 1
    assert engine.prefill_trace_count() == 1
    for _ in range(3):
        engine.generate(params, tcfg, batch, 16, device="cpu")
    assert engine.decode_trace_count() == 1
    engine.generate(params, tcfg, batch, 8, device="cpu")
    assert engine.decode_trace_count() == 2
    assert engine.executable_cache_size() == 2
    for _ in range(2):
        engine.generate_reference(params, tcfg, batch, 4, device="cpu")
    assert engine.reference_trace_count() == 2
    assert engine.executable_cache_size() == 2


def test_requests_are_validated_like_the_reference():
    _, tcfg = _configs("llama3.2-3b")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="mode"):
        engine.generate(params, tcfg, batch, 4, mode="best", device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.generate(params, tcfg, batch, 0, device="cpu")
    with pytest.raises(ValueError, match="params must live on"):
        engine.generate(TM.param_shapes(tcfg), tcfg, batch, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        TM.init_cache(get_arch("hymba-1.5b").reduced(), 1, 8, device="cpu")


def test_training_rwkv6_runs_and_the_card_gate_names_the_backward(capsys):
    """rwkv6 trains on the CPU (the plain WKV backward): the loss, the loop
    and the train CLI run, every grad is finite and the decay's and the
    bonus's params get one; on the card, training asks the WKV backward
    kernel's head dims first."""
    _, tcfg = _configs("rwkv6-3b")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.arange(8, dtype=torch.int64).reshape(1, 8)}
    leaves = [x.requires_grad_() for x in pop.tree_leaves(params)]
    loss, _ = TM.loss_fn(params, tcfg, batch)
    grads = dict(zip((p for p, _ in pop.tree_paths(params)),
                     torch.autograd.grad(loss, leaves)))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads.values())
    for leaf in ("w0", "w_lora_a", "w_lora_b", "u"):
        assert grads[("blocks", "rwkv", "tm", leaf)].abs().max() > 0, leaf
    res = loop.train_population(
        0, lambda s: TM.init_params(tcfg, seed=s, device="cpu"),
        lambda p, b: TM.loss_fn(p, tcfg, b)[0], lambda m, s, k: batch,
        TrainConfig(population=2, total_steps=1),
        MixingConfig(kind="wash", mode="bucketed"), tcfg.num_layers,
        device="cpu")
    assert np.isfinite(res.history["loss"]).all()
    train_cli.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "1",
                    "--batch-size", "1", "--seq-len", "8", "--device",
                    "cpu", "--population", "2"])
    assert "arch=rwkv6-3b-reduced" in capsys.readouterr().out
    reason = TM.cuda_supported(dataclasses.replace(tcfg, rwkv_head_dim=16),
                               "train")
    assert "backward" in reason and str(wkv.BACKWARD_HEAD_DIMS) in reason
    assert TM.cuda_supported(tcfg, "train") is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_scan_engine_on_the_cpu(arch, capsys):
    outs = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--population", "2", "--batch-size", "2",
                           "--seq-len", "6", "--max-new", "5", "--compare"])
    assert set(outs) == {"soup", "member", "ensemble"}
    for mode, res in outs.items():
        assert res["tokens"].shape == (2, 11) and res["tok_s"] > 0, mode
    printed = capsys.readouterr().out
    assert "soup/ensemble token agreement" in printed
    assert "kernel launches: flash attention 0, rwkv6 scan 0" in printed


def test_jax_population_file_serves_in_the_port(tmp_path):
    """A JAX rwkv6 population checkpoint serves through the port's CLI,
    each mode's tokens equal to the port's engine on the restored tree."""
    from repro.train import checkpoint as jckpt

    jcfg, tcfg = _configs("rwkv6-3b")
    jpop, tpop = _populations(jcfg, seed=5)
    path = str(tmp_path / "pop.npz")
    jckpt.save(path, jpop)
    outs = serve_cli.main(["--arch", "rwkv6-3b", "--reduced", "--device",
                           "cpu", "--population", "2", "--ckpt", path,
                           "--batch-size", "2", "--seq-len", "6",
                           "--max-new", "4", "--mode", "member",
                           "--member", "1"])
    batch = serve_cli.concrete_batch(tcfg, serve_cli.fold_in(0, 2), 2, 6,
                                     device="cpu")
    want = engine.generate(pop.member(tpop, 1), tcfg, batch, 4, device="cpu")
    assert torch.equal(outs["member"]["tokens"], want)


def test_every_serve_flag_has_help_text():
    """As ``tools/check_cli_help.py`` holds the JAX CLIs: no flag without
    help, and ``--help`` renders."""
    parser = serve_cli.build_parser()
    missing = [a.dest for a in parser._actions if not a.help]
    assert not missing
    text = parser.format_help()
    for flag in ("--batch-size", "--compare", "--continuous", "--mode",
                 "--temperature", "--max-new", "--seq-len"):
        assert flag in text
