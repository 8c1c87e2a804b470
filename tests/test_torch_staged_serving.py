"""Stage-split and data-mesh serving's host-side pieces against the JAX
package, in one process (JAX here, on the CPU).

  * ``staged_decode_supported`` gives JAX's verdict and text for every
    config and its reduced variant; ``generate``'s staged refusals raise
    JAX's exceptions with JAX's messages (``tests/test_pipeline.py``'s
    stand-in meshes);
  * ``rules.batch_pspecs`` and ``rules.cache_pspecs`` equal JAX's on
    stand-in meshes, for batches that divide over the data axes and
    batches that do not, over every cache leaf kind (k/v, ckv/krope,
    xk/xv, h/conv, S/x_tm/x_cm, pos_ids);
  * the stage functions (``prefill_embed`` / ``prefill_blocks``,
    ``decode_embed`` / ``decode_blocks``, ``lm_logits``) composed over 2
    and 4 slices of the blocks are the unstaged ``prefill`` +
    ``decode_step`` bitwise (logits and every cache leaf), for GQA and
    MLA, and within 1e-5 of JAX's on JAX's weights;
  * ``checkpoint.restore`` onto a stage's layout equals that stage's
    slice of a full restore; any other mismatch stays an error;
  * at world 1 the (1,) data mesh and the one-stage pipe mesh serve the
    unsharded tokens, through ``generate`` and the serve CLI; the CLI's
    refusals come before any weight; an ensemble-engine result whose
    process group is gone is refused, naming ``gather_population``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import transformer as JM
from repro.serving import engine as jengine
from repro.sharding import rules as jrules

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core import population as pop
from repro_torch.launch import serve
from repro_torch.launch.mesh import (EnsMesh, make_host_data_mesh,
                                     make_host_pipe_mesh)
from repro_torch.models import transformer as M
from repro_torch.serving import engine
from repro_torch.sharding import rules
from repro_torch.train import checkpoint
from repro_torch.train.interop import params_from_numpy
from repro_torch.train.loop import TrainResult

TINY = dict(name="tiny", d_model=32, d_ff=64, num_layers=4, num_heads=4,
            num_kv_heads=2, vocab_size=64, max_position=128,
            dtype="float32")
TINY_MLA = dict(TINY, name="tinymla", num_kv_heads=4, mla=True,
                kv_lora_rank=8, qk_rope_dim=4, qk_nope_dim=4, v_head_dim=8)
B, T, NEW = 2, 6, 5


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager models: the intra-op pool only spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(**shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


def _configs():
    out = []
    for name in ARCH_IDS:
        out += [(get_arch(name), jget_arch(name)),
                (get_arch(name).reduced(), jget_arch(name).reduced())]
    for kw in (TINY, TINY_MLA, dict(TINY, moe=True, n_routed_experts=4,
                                    top_k=2)):
        out.append((ModelConfig(**kw), JModelConfig(**kw)))
    return out


def test_staged_decode_supported_matches_jax():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    seen = set()
    for cfg, jcfg in _configs():
        want = JM.staged_decode_supported(jcfg)
        assert M.staged_decode_supported(cfg) == want, cfg.name
        seen.add(want is None)
    assert seen == {True, False}


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("not refused")


@pytest.mark.parametrize("case", ["ensemble", "uneven", "rwkv6", "vision",
                                  "pipe_only"])
def test_generate_refuses_bad_staged_requests_like_jax(case):
    kw, mode, shape = dict(TINY), "soup", dict(pipe=4)
    if case == "ensemble":
        mode = "ensemble"
    elif case == "uneven":
        kw["num_layers"] = 5
    elif case == "rwkv6":
        kw.update(block_kind="rwkv6", rwkv_head_dim=8)
    elif case == "vision":
        kw.update(frontend="vision", num_patches=4)
    else:
        shape = dict(data=2, pipe=4)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jparams = jax.eval_shape(
        lambda: JM.init_params(jax.random.key(0), JModelConfig(**TINY)))
    want = _refusal(lambda: jengine.generate(
        jparams, jcfg, {"tokens": jnp.zeros((2, 4), jnp.int32)}, 4,
        mode=mode, mesh=fake_mesh(**shape)))
    params = M.param_shapes(ModelConfig(**TINY))  # never reaches a device
    got = _refusal(lambda: engine.generate(
        params, cfg, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, 4,
        mode=mode, mesh=fake_mesh(**shape)))
    assert got == want


MESHES = [dict(data=2, model=2), dict(pod=2, data=2, model=1),
          dict(data=4, model=1), dict(model=4), dict(data=3, model=2),
          dict(pipe=4)]
CACHE_ARCHS = ["llama3.2-3b", "deepseek-v2-lite-16b", "whisper-medium",
               "hymba-1.5b", "rwkv6-3b", "internvl2-76b"]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_pspecs_match_jax(shape):
    mesh = fake_mesh(**shape)
    for name in ("llama3.2-3b", "whisper-medium", "internvl2-76b"):
        cfg, jcfg = get_arch(name).reduced(), jget_arch(name).reduced()
        for batch in (1, 4, 6, 12):
            got = rules.batch_pspecs(cfg, mesh, batch)
            want = jrules.batch_pspecs(jcfg, mesh, batch)
            assert sorted(got) == sorted(want), (name, batch)
            for k in want:
                assert tuple(got[k]) == tuple(want[k]), (name, batch, k)


@pytest.mark.parametrize("shape", [m for m in MESHES if "model" in m],
                         ids=str)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspecs_match_jax(shape, arch):
    mesh = fake_mesh(**shape)
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    for batch, cap in ((4, 24), (6, 24), (1, 32)):
        cache = M.init_cache(cfg, batch, cap, device="cpu")
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, batch, cap))
        got = list(pop.tree_paths(rules.cache_pspecs(cache, cfg, mesh, batch),
                                  is_leaf=rules.is_spec))
        want = jax.tree_util.tree_flatten_with_path(
            jrules.cache_pspecs(jcache, jcfg, mesh, batch),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        assert len(got) == len(want) > 0
        for (path, spec), (jpath, jspec) in zip(got, want):
            assert [str(p) for p in path] == [
                str(getattr(q, "key", getattr(q, "idx", q))) for q in jpath]
            assert tuple(spec) == tuple(jspec), (batch, path)


def _slices(blocks, stages, s, n_layers):
    n = n_layers // stages
    return pop.tree_map(lambda x: x[s * n:(s + 1) * n], blocks)


def _staged(params, cfg, tokens, stages, cap, steps):
    """The stage functions composed over ``stages`` slices: the prefill's
    last logits, each decode step's logits (fed the unstaged argmax
    tokens), and the stages' caches."""
    local = dataclasses.replace(cfg, num_layers=cfg.num_layers // stages)
    caches = [M.init_cache(local, tokens.shape[0], cap, device="cpu")
              for _ in range(stages)]
    h = M.prefill_embed(params, cfg, {"tokens": tokens})
    for s in range(stages):
        h, caches[s] = M.prefill_blocks(
            _slices(params["blocks"], stages, s, cfg.num_layers), local, h,
            caches[s])
    logits = [M.lm_logits(params, cfg, h[:, -1:])]
    for i, tok in enumerate(steps):
        h = M.decode_embed(params, cfg, tok, T + i)
        for s in range(stages):
            h, caches[s] = M.decode_blocks(
                _slices(params["blocks"], stages, s, cfg.num_layers), local,
                h, caches[s], T + i)
        logits.append(M.lm_logits(params, cfg, h))
    return logits, caches


@pytest.mark.parametrize("kw", [TINY, TINY_MLA], ids=["gqa", "mla"])
def test_stage_functions_compose_to_the_unstaged_engine(kw):
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    rng = np.random.default_rng(3)  # numpy draws: JAX's eager init is slow
    weights = pop.tree_map(
        lambda m: (0.3 * rng.standard_normal(tuple(m.shape))).astype(
            np.float32), M.param_shapes(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    assert (jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))))
    params = params_from_numpy(weights, "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (B, T)).astype(np.int32))
    cap = T + NEW
    with torch.no_grad():
        lg, cache = M.prefill(params, cfg, {"tokens": tokens}, capacity=cap)
        want, steps = [lg], []
        for i in range(NEW - 1):
            steps.append(want[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = M.decode_step(params, cfg, steps[-1], cache, T + i)
            want.append(lg)
        for stages in (2, 4):
            got, caches = _staged(params, cfg, tokens, stages, cap, steps)
            for a, b in zip(got, want):
                assert torch.equal(a, b), stages
            n = cfg.num_layers // stages
            for s, c in enumerate(caches):
                for x, y in zip(pop.tree_leaves(c), pop.tree_leaves(cache)):
                    assert torch.equal(x, y[s * n:(s + 1) * n]), (stages, s)

    # JAX's stage functions on the same weights, two stages, one program
    jlocal = dataclasses.replace(jcfg, num_layers=jcfg.num_layers // 2)

    def jax_staged(jp, jtok, jsteps):
        caches = [JM.init_cache(jlocal, B, cap) for _ in range(2)]
        blks = [jax.tree_util.tree_map(lambda x: x[s * 2:(s + 1) * 2],
                                       jp["blocks"]) for s in range(2)]
        h = JM.prefill_embed(jp, jcfg, {"tokens": jtok})
        for s in range(2):
            h, caches[s] = JM.prefill_blocks(blks[s], jlocal, h, caches[s])
        out = [JM.lm_logits(jp, jcfg, h[:, -1:])]
        for i, tok in enumerate(jsteps):
            h = JM.decode_embed(jp, jcfg, tok, T + i)
            for s in range(2):
                h, caches[s] = JM.decode_blocks(blks[s], jlocal, h,
                                                caches[s], T + i)
            out.append(JM.lm_logits(jp, jcfg, h))
        return out

    jlogits = jax.jit(jax_staged)(jp, jnp.asarray(tokens.numpy()),
                                  [jnp.asarray(t.numpy()) for t in steps])
    for a, b in zip(want, jlogits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_restore_onto_a_stage_is_the_slice_of_a_full_restore(tmp_path):
    cfg = ModelConfig(**TINY)
    popn = pop.stack([M.init_params(cfg, seed=s, device="cpu")
                      for s in range(2)])
    path = checkpoint.save(str(tmp_path / "pop"), popn)
    full = checkpoint.restore(path, popn)
    for stages in (2, 4):
        n = cfg.num_layers // stages
        for s in range(stages):
            like = {**popn, "blocks": pop.tree_map(
                lambda x: x[:, :n], popn["blocks"])}
            got = checkpoint.restore(path, like, stage=(s, stages))
            want = {**full, "blocks": pop.tree_map(
                lambda x: x[:, s * n:(s + 1) * n], full["blocks"])}
            for (p, a), (_, b) in zip(pop.tree_paths(got),
                                      pop.tree_paths(want)):
                assert a.shape == b.shape and torch.equal(a, b), p
    like = {**popn, "blocks": pop.tree_map(lambda x: x[:, :3],
                                           popn["blocks"])}
    with pytest.raises(ValueError, match="blocks"):
        checkpoint.restore(path, like, stage=(0, 2))
    with pytest.raises(ValueError, match="blocks"):  # no stage given
        checkpoint.restore(path, {**popn, "blocks": pop.tree_map(
            lambda x: x[:, :2], popn["blocks"])})
    with pytest.raises(ValueError, match="embed"):  # not a blocks leaf
        checkpoint.restore(path, {**popn, "embed": {"tok": popn["embed"][
            "tok"][:, :32]}}, stage=(0, 2))


ARGV = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
        "--population", "2", "--batch-size", "4", "--seq-len", "8",
        "--max-new", "4"]


def test_world_one_meshes_serve_the_unsharded_tokens(capsys):
    cfg = ModelConfig(**TINY)
    popn = pop.stack([M.init_params(cfg, seed=s, device="cpu")
                      for s in range(2)])
    tokens = torch.randint(0, 64, (3, T), generator=torch.Generator()
                           .manual_seed(0))
    for mode in ("soup", "ensemble"):
        params = engine.serving_params(popn, mode)
        for temp, seed in ((0.0, None), (0.8, 5)):
            want = engine.generate(params, cfg, {"tokens": tokens}, NEW,
                                   temperature=temp, seed=seed, mode=mode,
                                   device="cpu")
            for mesh in (make_host_data_mesh("cpu"),
                         make_host_pipe_mesh(1, "cpu")):
                got = engine.generate(params, cfg, {"tokens": tokens}, NEW,
                                      temperature=temp, seed=seed, mode=mode,
                                      mesh=mesh)
                assert torch.equal(got, want), (mode, temp, mesh.axis_names)
    plain = serve.main(ARGV)["soup"]["tokens"]
    for extra in (["--mesh", "data"], ["--pp-stages", "1"]):
        out = serve.main(ARGV + extra)
        assert torch.equal(out["soup"]["tokens"], plain), extra
    printed = capsys.readouterr().out
    assert "mesh: {'data': 1}" in printed and "mesh: {'pipe': 1}" in printed
    assert "batch split over the data group: 4 rows a rank" in printed


@pytest.mark.parametrize("extra, msg", [
    (["--pp-stages", "2"], "needs that many ranks"),
    (["--pp-stages", "2", "--mesh", "data"], "drop --mesh"),
    (["--mesh", "data", "--continuous"], "single-host runtime"),
    (["--pp-stages", "1", "--driver"], "single-host runtime"),
    (["--mesh", "data", "--train-steps", "2"], "--ckpt-population"),
])
def test_serve_cli_refuses_mesh_options_before_any_weight(extra, msg,
                                                          monkeypatch,
                                                          capsys):
    def no_weights(*a, **k):
        raise AssertionError("a weight was made")

    monkeypatch.setattr(M, "init_params", no_weights)
    with pytest.raises(SystemExit):
        serve.main(ARGV + extra)
    assert msg in capsys.readouterr().err


def test_a_block_whose_group_is_gone_is_never_souped():
    cfg = ModelConfig(**TINY)
    block = pop.stack([M.init_params(cfg, seed=s, device="cpu")
                       for s in range(2)])
    mesh = EnsMesh(rank=1, world=2, n_local=2, member_offset=2,
                   device=torch.device("cpu"))
    res = TrainResult(block, {}, {}, 0.0, member_offset=2, mesh=mesh)
    for mode in ("soup", "member", "ensemble"):
        with pytest.raises(ValueError, match="gather_population"):
            engine.serving_params(res, mode)
    with pytest.raises(ValueError, match="gather_population"):
        engine.averaged_params(res)
    # at world 1 the result is the whole population
    res.mesh = EnsMesh(rank=0, world=1, n_local=2, member_offset=0,
                       device=torch.device("cpu"))
    soup = engine.serving_params(res, "soup")
    for a, b in zip(pop.tree_leaves(soup),
                    pop.tree_leaves(engine.averaged_params(block))):
        assert torch.equal(a, b)
