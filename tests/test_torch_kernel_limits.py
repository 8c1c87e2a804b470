"""The card's kernel limits, asked where a run on the card starts.

``models.transformer.cuda_supported`` names the reason a config's shapes
do not fit the CUDA kernels (the WKV kernel's and its backward's head
dims, flash attention's head dims, the paged kernel's group and head
dim, the selective-scan kernel's state sizes and its backward's longest
sequence), from the kernel modules' own constants.  ``ContinuousServer``,
``engine.generate``, the serve CLI and the train CLI ask it for a run on
the card before any weight reaches the card, and refuse with
``NotImplementedError``; the CPU path keeps serving any head dim through
the plain versions.

Imports neither JAX nor the JAX package, so the ``gpu`` tests run on the
machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernel_limits.py

On the CPU, a run "on the card" is the entry point with its
``resolve_device`` made to answer ``cuda``: the gate must refuse before
anything else touches the device.
"""

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import population as pop
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import selective_scan as ssk
from repro_torch.launch import serve
from repro_torch.models import transformer as M
from repro_torch.serving import batching
from repro_torch.serving import engine

CUDA = torch.device("cuda", 0)

RWKV16 = get_arch("rwkv6-3b").reduced(rwkv_head_dim=16)
ATTN96 = get_arch("llama3.2-3b").reduced(head_dim=96)
GROUP9 = get_arch("llama3.2-3b").reduced(num_heads=9, num_kv_heads=1,
                                         head_dim=64)
HD256 = get_arch("llama3.2-3b").reduced(head_dim=256)
DEEPSEEK = get_arch("deepseek-v2-lite-16b")
# the reduced MLA widths, (32 + 16, 32): no flash instantiation
MLA48 = DEEPSEEK.reduced()
# the reduced model at the full model's MLA widths, (128 + 64, 128)
MLA192 = DEEPSEEK.reduced(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
WHISPER = get_arch("whisper-medium")
INTERNVL2 = get_arch("internvl2-76b")


@pytest.mark.parametrize("cfg,path,limit", [
    (RWKV16, "scan", str(wkv.HEAD_DIMS)),
    (ATTN96, "scan", str(fa.HEAD_DIMS)),
    (GROUP9, "continuous", f"at most {pa.MAX_GROUP}"),
    (HD256, "continuous", f"at most {pa.MAX_HEAD_DIM}"),
    (RWKV16, "train", str(wkv.BACKWARD_HEAD_DIMS)),
    (MLA48, "scan", str(fa.HEAD_DIMS)),
    (WHISPER, "continuous", "encoder-decoder cross-attention cache is not "
                            "paged"),
], ids=["rwkv6-hd16", "attn-hd96", "paged-group9", "paged-hd256",
        "rwkv6-hd16-train", "mla-48x32", "whisper-continuous"])
def test_refuses_what_the_kernels_cannot_take(cfg, path, limit):
    reason = M.cuda_supported(cfg, path)
    assert reason is not None and limit in reason


@pytest.mark.parametrize("kernel,dims", [("HEAD_DIMS", (64,)),
                                         ("BACKWARD_HEAD_DIMS", (64,))],
                         ids=["forward", "backward"])
def test_train_gate_asks_both_wkv_kernels(kernel, dims, monkeypatch):
    """Training runs the WKV kernel forward and its backward kernel: a head
    dim that either refuses is refused before the first step."""
    monkeypatch.setattr(wkv, kernel, dims)
    reason = M.cuda_supported(get_arch("rwkv6-3b").reduced(), "train")
    assert reason is not None and str(dims) in reason


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_takes_the_shipped_configs(arch, reduced):
    cfg = get_arch(arch)
    cfg = cfg.reduced() if reduced else cfg
    assert M.cuda_supported(cfg, "scan") is None
    assert M.cuda_supported(cfg, "train") is None
    if cfg.block_kind == "attn":
        assert M.cuda_supported(cfg, "continuous") is None


@pytest.mark.parametrize("cfg", [DEEPSEEK, MLA192,
                                 get_arch("kimi-k2-1t-a32b"),
                                 get_arch("kimi-k2-1t-a32b").reduced()],
                         ids=["deepseek", "deepseek-reduced-192x128",
                              "kimi-k2", "kimi-k2-reduced"])
def test_takes_the_moe_configs(cfg):
    """DeepSeek-V2-Lite's MLA widths (192, 128) are an instantiation of
    the flash kernel; kimi-k2 is GQA with group 8 and head dim 128.  Both
    train on the card: MLA's training attention is plain, as GQA's is."""
    assert M.attention_dims(cfg) in fa.HEAD_DIMS
    assert M.cuda_supported(cfg, "scan") is None
    assert M.cuda_supported(cfg, "train") is None
    if not cfg.mla:
        assert M.cuda_supported(cfg, "continuous") is None


@pytest.mark.parametrize("cfg,reason", [
    (WHISPER, "encoder-decoder cross-attention cache is not paged"),
    (WHISPER.reduced(), "encoder-decoder cross-attention cache is not paged"),
    (INTERNVL2, "frontend='vision' prefixes are not paged"),
    (INTERNVL2.reduced(), "frontend='vision' prefixes are not paged"),
    (DEEPSEEK, "MLA latent cache has no paged layout yet"),
], ids=["whisper", "whisper-reduced", "internvl2", "internvl2-reduced",
        "deepseek"])
def test_takes_the_last_families_on_the_scan_engine_and_in_training(
        cfg, reason):
    """whisper's attention (encoder, decoder and cross, head dim 64) and
    internvl2's (head dim 128, group 8) are flash instantiations; both
    train, and DeepSeek-V2-Lite trains.  Continuous batching refuses all
    three with the reference's reasons."""
    assert M.attention_dims(cfg) in fa.HEAD_DIMS
    assert M.cuda_supported(cfg, "scan") is None
    assert M.cuda_supported(cfg, "train") is None
    assert M.cuda_supported(cfg, "continuous") == reason
    assert M.paged_decode_supported(cfg) == reason


HYMBA = get_arch("hymba-1.5b")


@pytest.mark.parametrize("cfg", [HYMBA, HYMBA.reduced()],
                         ids=["full", "reduced"])
def test_takes_hymba_on_the_scan_engine_and_in_training(cfg):
    """hymba's attention (head dim 64, group 5 at full width) is a flash
    instantiation and its 16 states the selective-scan kernel's; its
    state is not paged, so continuous batching refuses it with the
    reference's reason."""
    assert M.attention_dims(cfg) in fa.HEAD_DIMS
    assert cfg.ssm_state in ssk.STATE_DIMS
    assert M.cuda_supported(cfg, "scan") is None
    assert M.cuda_supported(cfg, "train") is None
    reason = M.cuda_supported(cfg, "continuous")
    assert reason == M.paged_decode_supported(cfg)
    assert reason == "block_kind='hybrid' state is not paged"


@pytest.mark.parametrize("seq_len,refused", [
    (4096, False), (ssk.MAX_BACKWARD_T, False), (ssk.MAX_BACKWARD_T + 1, True)],
    ids=["train_4k", "longest", "too-long"])
def test_train_gate_asks_the_scan_backward_for_the_length(seq_len, refused):
    """The selective-scan backward takes at most ``MAX_BACKWARD_T`` steps:
    a longer training sequence is refused before the first step, not after
    its forward."""
    reason = M.cuda_supported(HYMBA, "train", seq_len)
    assert (reason is not None) == refused
    if refused:
        assert f"at most {ssk.MAX_BACKWARD_T} steps" in reason
    assert M.cuda_supported(get_arch("llama3.2-3b"), "train",
                            ssk.MAX_BACKWARD_T + 1) is None


@pytest.mark.parametrize("path", ["scan", "train"])
def test_refuses_a_state_size_the_scan_kernel_lacks(path):
    cfg = HYMBA.reduced(ssm_state=8)
    reason = M.cuda_supported(cfg, path)
    assert reason is not None and "selective-scan" in reason
    assert str(ssk.STATE_DIMS) in reason


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="path"):
        M.cuda_supported(RWKV16, "paged")


def _on_the_card(monkeypatch, module):
    """``module``'s entry point believes it runs on the card; no build may
    happen."""
    monkeypatch.setattr(module, "resolve_device", lambda device: CUDA)
    for kernel in (fa, pa, wkv, ssk):
        monkeypatch.setattr(kernel, "build",
                            lambda: pytest.fail("a kernel was built"))


def _params(cfg):
    return M.init_params(cfg, seed=0, device="cpu")


def _batch(cfg, B=2, S=8):
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=torch.Generator().manual_seed(0))}


@pytest.mark.parametrize("cfg", [RWKV16, ATTN96], ids=["rwkv6-hd16",
                                                        "attn-hd96"])
def test_generate_on_the_card_refuses_first(monkeypatch, cfg):
    _on_the_card(monkeypatch, engine)
    with pytest.raises(NotImplementedError, match="head dims"):
        engine.generate(_params(cfg), cfg, _batch(cfg), 4, device="cuda")


@pytest.mark.parametrize("cfg", [GROUP9, HD256], ids=["group9", "hd256"])
def test_continuous_server_on_the_card_refuses_first(monkeypatch, cfg):
    _on_the_card(monkeypatch, batching)
    with pytest.raises(NotImplementedError, match="paged-attention kernel"):
        batching.ContinuousServer(_params(cfg), cfg, device="cuda")


@pytest.mark.parametrize("continuous", [False, True], ids=["scan",
                                                           "continuous"])
def test_serve_cli_on_the_card_refuses_before_the_weights(monkeypatch,
                                                          continuous):
    cfg = GROUP9 if continuous else RWKV16
    _on_the_card(monkeypatch, serve)
    monkeypatch.setattr(serve, "get_arch", lambda name: cfg)
    monkeypatch.setattr(serve, "_population",
                        lambda *a: pytest.fail("weights were made"))
    argv = ["--arch", "any", "--population", "2"]
    with pytest.raises(NotImplementedError, match="kernel"):
        serve.main(argv + (["--continuous"] if continuous else []))


def test_train_cli_on_the_card_refuses_before_the_weights(monkeypatch):
    from repro_torch.launch import train

    _on_the_card(monkeypatch, train)
    monkeypatch.setattr(train, "get_arch", lambda name: RWKV16)
    monkeypatch.setattr(M, "init_params",
                        lambda *a, **k: pytest.fail("weights were made"))
    with pytest.raises(NotImplementedError, match="backward kernel"):
        train.main(["--arch", "any", "--population", "2", "--steps", "1"])


def test_train_cli_on_the_card_refuses_a_sequence_too_long(monkeypatch):
    from repro_torch.launch import train

    _on_the_card(monkeypatch, train)
    monkeypatch.setattr(train, "get_arch", lambda name: HYMBA)
    monkeypatch.setattr(M, "init_params",
                        lambda *a, **k: pytest.fail("weights were made"))
    with pytest.raises(NotImplementedError, match="selective-scan backward"):
        train.main(["--arch", "any", "--population", "2", "--steps", "1",
                    "--seq-len", str(ssk.MAX_BACKWARD_T + 1)])


def test_the_cpu_path_serves_any_head_dim():
    """The plain versions take rwkv_head_dim=16, as the reference does."""
    cfg = RWKV16
    params = pop.stack([_params(cfg), _params(cfg)])
    soup = engine.serving_params(params, "soup")
    out = engine.generate(soup, cfg, _batch(cfg), 4, device="cpu")
    assert out.shape == (2, 12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_card_refuses_before_any_kernel_builds(cuda_device, monkeypatch):
    for kernel in (fa, pa, wkv):
        monkeypatch.setattr(kernel, "build",
                            lambda: pytest.fail("a kernel was built"))
    for cfg in (RWKV16, ATTN96):
        params = M.init_params(cfg, seed=0, device=cuda_device)
        batch = {"tokens": _batch(cfg)["tokens"].to(cuda_device)}
        with pytest.raises(NotImplementedError, match="head dims"):
            engine.generate(params, cfg, batch, 4, device=cuda_device)
    for cfg in (GROUP9, HD256):
        params = M.init_params(cfg, seed=0, device=cuda_device)
        with pytest.raises(NotImplementedError,
                           match="paged-attention kernel"):
            batching.ContinuousServer(params, cfg, device=cuda_device)
