"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

O(1)-state decode: runs the long_500k shape natively.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # D / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    block_kind="rwkv6",
    rwkv_head_dim=64,
    source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
)
