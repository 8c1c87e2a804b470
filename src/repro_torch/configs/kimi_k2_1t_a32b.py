"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table scale) [arXiv:2501.kimi2].

384 routed experts, top-8, per-expert hidden 2048, 61 layers.  This config
exists for the dry-run/roofline table: its training state exceeds a single
256-chip v5e pod's HBM (recorded, not hidden, in EXPERIMENTS.md §Dry-run).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,  # GQA per the assignment table
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    moe=True,
    n_routed_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    source="arXiv:2501.kimi2 (Kimi K2)",
)
