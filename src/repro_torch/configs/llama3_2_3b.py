"""llama3.2-3b — small Llama-3 dense LM [hf:meta-llama/Llama-3.2-1B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-1B (3B sibling config)",
)
