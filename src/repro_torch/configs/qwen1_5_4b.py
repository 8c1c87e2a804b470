"""qwen1.5-4b — dense MHA LM with QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,  # MHA (kv == q heads)
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B (4B sibling config)",
)
