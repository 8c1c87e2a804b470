"""The card's kernel limits, asked where a run on the card starts.

``models.transformer.cuda_supported`` names the reason a config's shapes
do not fit the CUDA kernels (the WKV kernel's and its backward's head
dims, flash attention's head dims, the paged kernel's group and head
dim), from the kernel modules' own constants.  ``ContinuousServer``,
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


@pytest.mark.parametrize("cfg,path,limit", [
    (RWKV16, "scan", str(wkv.HEAD_DIMS)),
    (ATTN96, "scan", str(fa.HEAD_DIMS)),
    (GROUP9, "continuous", f"at most {pa.MAX_GROUP}"),
    (HD256, "continuous", f"at most {pa.MAX_HEAD_DIM}"),
    (RWKV16, "train", str(wkv.BACKWARD_HEAD_DIMS)),
], ids=["rwkv6-hd16", "attn-hd96", "paged-group9", "paged-hd256",
        "rwkv6-hd16-train"])
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


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="path"):
        M.cuda_supported(RWKV16, "paged")


def _on_the_card(monkeypatch, module):
    """``module``'s entry point believes it runs on the card; no build may
    happen."""
    monkeypatch.setattr(module, "resolve_device", lambda device: CUDA)
    for kernel in (fa, pa, wkv):
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
