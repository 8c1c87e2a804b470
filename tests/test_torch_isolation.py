"""The port stands alone: ``repro_torch`` imports neither JAX nor any
module of the JAX package, its entry points run on the card unless the
caller asks for the CPU, and the CPU routes of ``ops.paged_attention``
and the shuffles never reach the CUDA kernels' build."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.configs.base import TrainConfig
from repro_torch.core.mixing import MixingConfig
from repro_torch.kernels import wash_shuffle as ws
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TM
from repro_torch.train import loop
from repro_torch.serving import batching as TB
from repro_torch.serving import engine as TE
from repro_torch.configs import get_arch
from repro_torch.models import ssm as SSM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  d_ff=64, vocab_size=50, dtype="float32")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "repro_torch.serving.batching" in mods and len(mods) >= 30
    for name in ("train.loop", "launch.train", "kernels.wash_shuffle",
                 "kernels.build", "core.shuffle", "core.mixing", "optim",
                 "data.synthetic", "kernels.flash_attention",
                 "kernels.rwkv6_scan", "kernels.selective_scan",
                 "models.ssm", "serving.engine",
                 "models.cnn", "data.augment", "core.averaging",
                 "launch.quickstart", "serving.driver",
                 "serving.speculative", "obs", "obs.metrics", "obs.events",
                 "obs.profiler", "train.engine", "train.schedule",
                 "launch.mesh", "core.shardplan", "sharding",
                 "sharding.rules"):
        assert f"repro_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(CFG)
    params = TM.init_params(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.ContinuousServer(params, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3.2-3b", "--reduced", "--continuous",
                    "--population", "1", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3.2-3b", "--reduced", "--driver",
                    "--speculative", "--population", "1", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.train_population(0, lambda s: params, None, None,
                              TrainConfig(population=1, total_steps=1),
                              MixingConfig(), CFG.num_layers)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-3b", "--reduced", "--population", "1",
                    "--batch-size", "1", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.generate(params, CFG, {"tokens": torch.zeros((1, 2),
                                                        dtype=torch.int32)}, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(CFG, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSM.rwkv_state_init(get_arch("rwkv6-3b").reduced(), 1, 1)
    hymba = get_arch("hymba-1.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSM.mamba_state_init(hymba, 1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(hymba, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "hymba-1.5b", "--reduced", "--population", "1",
                    "--batch-size", "1", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "hymba-1.5b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.paged_pools_init(CFG, 4, 2, CFG.num_layers)
    pools = TL.paged_pools_init(CFG, 4, 2, CFG.num_layers, device="cpu")
    assert pools["k"].device.type == "cpu"


def test_server_refuses_params_on_another_device():
    params = TM.param_shapes(CFG)  # meta tensors: not on the CPU
    with pytest.raises(ValueError, match="params must live on cpu"):
        TB.ContinuousServer(params, CFG, device="cpu")


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the CUDA kernel")

    monkeypatch.setattr(pa, "build", refuse)
    monkeypatch.setattr(pa, "paged_attention_cuda", refuse)
    launches = pa.launches
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((5, 4, 2, 8))
                            .astype(np.float32))
    out = ops.paged_attention(q, pool, pool,
                              torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
                              torch.tensor([5, 2], dtype=torch.int32))
    assert out.shape == q.shape and out.dtype == q.dtype
    assert pa.launches == launches and pa._lib is None


def test_cuda_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    monkeypatch.setattr(pa, "build", lambda: pytest.fail("built"))
    x = torch.zeros(1, 2, 8)
    pool = torch.zeros(2, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(x, pool, pool,
                                torch.zeros(1, 1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))


def test_shuffle_routes_never_build_for_cpu_tensors(monkeypatch):
    monkeypatch.setattr(ws, "build", lambda: pytest.fail("built"))
    x = torch.arange(12.0).reshape(3, 4)
    ops.bucketed_shuffle_(x, torch.tensor([[0], [1], [2]], dtype=torch.int32))
    ops.wash_shuffle(x, torch.zeros(3, 4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.bool))
    assert ws._lib is None


def test_plan_and_data_helpers_default_to_the_card(no_card):
    from repro_torch.core import shuffle as shf
    from repro_torch.data import make_lm_task
    from repro_torch.launch.specs import concrete_batch

    for call in (lambda: shf.dense_plan(0, (4,), 2, 0.5),
                 lambda: shf.bucketed_plan(0, 64, 2, 0.5),
                 lambda: shf.stratified_unique_indices(0, 64, 4),
                 lambda: make_lm_task(0, vocab=8),
                 lambda: concrete_batch(CFG, 0, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert shf.bucketed_plan(0, 64, 2, 0.5, device="cpu").device.type == "cpu"


def test_image_path_defaults_to_the_card(no_card):
    from repro_torch.core.population import tree_leaves
    from repro_torch.data import make_image_task
    from repro_torch.launch import quickstart
    from repro_torch.models import cnn

    cfg = cnn.ClassifierConfig(kind="resnet", width=4, depth=2, image_hw=6)
    for call in (lambda: cnn.init_classifier(0, cfg),
                 lambda: make_image_task(0, hw=6),
                 lambda: quickstart.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = cnn.init_classifier(0, cfg, device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(params))
    assert make_image_task(0, hw=6, device="cpu").prototypes.device.type == "cpu"
