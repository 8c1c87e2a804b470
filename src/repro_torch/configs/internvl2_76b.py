"""internvl2-76b — VLM: InternViT (stub) + InternLM2-like LM [arXiv:2404.16821].

The vision encoder + projector are a STUB per the assignment:
``input_specs`` feeds 256 precomputed patch embeddings that are prepended
to the text sequence; the 80-layer LM backbone is fully implemented.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    num_patches=256,
    source="arXiv:2404.16821 (InternVL2-76B, LM backbone)",
)
