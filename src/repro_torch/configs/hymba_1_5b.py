"""hymba-1.5b — hybrid parallel attention + Mamba heads [arXiv:2411.13676].

Every block runs a GQA sliding-window attention head-group in parallel
with a selective-SSM (Mamba) path; outputs are fused with a learned
softmax gate.  Hymba's meta-tokens and the few global-attention layers are
simplified to uniform SWA (noted in DESIGN.md).  SWA + SSM state make this
arch sub-quadratic, so it runs the long_500k shape.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,  # GQA
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block_kind="hybrid",
    ssm_state=16,
    window=1024,
    source="arXiv:2411.13676 (Hymba-1.5B)",
)
