"""Whole models of the other architectures against the JAX package.

At ``reduced()`` size, float32, on JAX weights carried across by
``params_from_numpy``: three dense configs (qwen3-4b with ``qk_norm``,
qwen1.5-4b with ``qkv_bias`` and one kv head a query head, minitron-8b)
and the two MoE configs (deepseek-v2-lite-16b with MLA, kimi-k2 with
GQA).  For each, the training forward's logits and the loss (the MoE
router's aux loss included) within 1e-4, and greedy tokens equal to
JAX's, token for token, through the scan engine and, where the paged
gates take the config, through ``ContinuousServer``.  The paged gates
give the reference's reasons (MLA is refused, MoE is not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as JM
from repro.serving import batching as JB
from repro.serving import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.models import transformer as TM
from repro_torch.serving import batching as TB
from repro_torch.serving import engine
from repro_torch.train.interop import params_from_numpy

DENSE = ["qwen3-4b", "qwen1.5-4b", "minitron-8b"]
MOE = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
ARCHS = DENSE + MOE
# one serving mode each: the MoE models as the ensemble of two members
SCAN_MODE = {a: "soup" for a in DENSE} | {a: "ensemble" for a in MOE}
SERVER = dict(page_size=4, max_slots=3, num_pages=40, prefill_chunk=4)
STREAM = [(8, 5), (12, 4), (8, 3), (12, 6)]  # (prompt, max_new) a request


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
        jpop = jax.vmap(lambda k: JM.init_params(k, jcfg))(
            jax.random.split(jax.random.key(7), 2))
        tpop = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpop),
                                 device="cpu")
        _POPS[arch] = (jcfg, tcfg, jpop, tpop)
    return _POPS[arch]


def _member(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, tcfg, jpop, tpop = _setup(arch)
    jp, tp = _member(jpop, 0), _member(tpop, 0)
    batch = _tokens(tcfg, (2, 16), 1)
    jlog, jaux = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(batch)})
    tlog, taux = TM.forward_logits(tp, tcfg,
                                   {"tokens": torch.from_numpy(batch)})
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-4)
    assert (float(jaux) > 0) == tcfg.moe
    jloss, jm = JM.loss_fn(jp, jcfg, {"tokens": jnp.asarray(batch)})
    tloss, tm = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_engine_greedy_tokens_match_jax(arch):
    jcfg, tcfg, jpop, tpop = _setup(arch)
    mode = SCAN_MODE[arch]
    prompts = _tokens(tcfg, (3, 9), 2)
    want = jengine.generate_from_population(
        jpop, jcfg, {"tokens": jnp.asarray(prompts)}, 6, mode=mode)
    engine.clear_executable_cache()
    got = engine.generate_from_population(
        tpop, tcfg, {"tokens": torch.from_numpy(prompts)}, 6, mode=mode,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_gates_give_the_reference_reasons(arch):
    jcfg, tcfg, _, _ = _setup(arch)
    assert TM.paged_decode_supported(tcfg) == JM.paged_decode_supported(jcfg)
    assert (TM.paged_prefill_supported(tcfg)
            == JM.paged_prefill_supported(jcfg))
    assert TM.scan_supported(tcfg) is None
    if tcfg.mla:
        assert TM.paged_decode_supported(tcfg) is not None
        with pytest.raises(NotImplementedError, match="MLA"):
            TB.ContinuousServer(_member(_setup(arch)[3], 0), tcfg,
                                device="cpu")
    else:
        assert TM.paged_decode_supported(tcfg) is None


@pytest.mark.parametrize("arch", DENSE + ["kimi-k2-1t-a32b"])
def test_continuous_greedy_tokens_match_jax(arch):
    jcfg, tcfg, jpop, tpop = _setup(arch)
    stream = [(u, _tokens(tcfg, (S,), 10 + u), m)
              for u, (S, m) in enumerate(STREAM)]
    jserver = JB.ContinuousServer.from_trained(jpop, jcfg, mode="soup",
                                               **SERVER)
    tserver = TB.ContinuousServer.from_trained(tpop, tcfg, mode="soup",
                                               **SERVER, device="cpu")
    jout = jserver.run([JB.Request(u, p, m) for u, p, m in stream])
    tout = tserver.run([TB.Request(u, p, m) for u, p, m in stream])
    assert set(tout) == set(jout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid].tokens, jout[uid].tokens,
                                      err_msg=f"{arch} request {uid}")
