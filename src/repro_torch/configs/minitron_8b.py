"""minitron-8b — pruned Nemotron dense LM [arXiv:2407.14679]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2407.14679 (Minitron: pruned Nemotron-4)",
)
