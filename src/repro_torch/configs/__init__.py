"""Architecture registry: the 10 assigned architectures, keyed by public id.

``get_arch("minitron-8b")`` returns the exact assigned ModelConfig;
``get_arch(id).reduced()`` is the CPU smoke-test variant (2 layers,
d_model<=256, <=4 experts).
"""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    INPUT_SHAPES_BY_NAME,
    InputShape,
    ModelConfig,
    TrainConfig,
)
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.internvl2_76b import CONFIG as _internvl
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen15

ARCHS = {
    c.name: c
    for c in (
        _minitron,
        _llama32,
        _dsv2,
        _whisper,
        _qwen3,
        _hymba,
        _rwkv6,
        _kimi,
        _internvl,
        _qwen15,
    )
}

ARCH_IDS = tuple(ARCHS.keys())


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = [
    "ARCHS",
    "ARCH_IDS",
    "get_arch",
    "ModelConfig",
    "TrainConfig",
    "InputShape",
    "INPUT_SHAPES",
    "INPUT_SHAPES_BY_NAME",
]
