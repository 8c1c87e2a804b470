"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

MLA latent cache: kv_lora_rank=512, decoupled rope dim 64.  MoE: 2 shared
+ 64 routed experts, top-6, per-expert hidden 1408.  (The assignment
header says 64e; its bracket note says 160 routed — we follow the header
and the model card; the expert count is one config field either way.)
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: per-head latents, kv head count unused
    d_ff=1408,
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=True,
    n_routed_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
