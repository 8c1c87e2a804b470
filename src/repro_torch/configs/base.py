"""Model / run configuration dataclasses shared by the whole framework."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned architecture family.

    Families: dense | moe | ssm | hybrid | audio | vlm.
    ``block_kind``: attn | rwkv6 | hybrid (attn ∥ mamba).
    """

    name: str = "model"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 1000
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window attention size (tokens)

    # MLA (DeepSeek-V2 style multi-head latent attention)
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden dim (defaults d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / RWKV / hybrid
    block_kind: str = "attn"  # attn | rwkv6 | hybrid
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    num_frames: int = 1500  # encoder sequence length (stubbed frontend)

    # modality frontend stubs
    frontend: Optional[str] = None  # None | "audio" | "vision"
    num_patches: int = 0  # vision tokens prepended to the text sequence

    # positions
    pos_kind: str = "rope"  # rope | learned (whisper)
    max_position: int = 32768  # learned-pos table size

    # lowering: unroll factor for the block scan.  1 = rolled while-loop
    # (fast compile; XLA cost_analysis counts the body ONCE).  num_layers =
    # fully unrolled (dry-run default so roofline FLOPs/bytes are complete).
    scan_unroll: int = 1

    # performance knobs (§Perf hillclimbs; defaults = paper-faithful baseline)
    attn_impl: str = "naive"   # naive (materializes SxS) | chunked (online softmax)
    attn_chunk: int = 1024     # kv-chunk size for attn_impl=chunked
    remat_blocks: bool = False # activation-checkpoint each block in training
    moe_impl: str = "global"   # global (one dispatch over all tokens) |
                               # grouped (per-batch-row dispatch: buffers are
                               # data-local, exchange lowers to all-to-all)
    shard_hints: bool = False  # activate in-model GSPMD sharding constraints

    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""  # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode: SSM state or sliding-window KV."""
        return self.block_kind in ("rwkv6", "hybrid") or self.window is not None

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_nope_dim=32 if self.mla else self.qk_nope_dim,
            qk_rope_dim=16 if self.mla else self.qk_rope_dim,
            v_head_dim=32 if self.mla else self.v_head_dim,
            n_routed_experts=min(self.n_routed_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.resolved_moe_d_ff, 128) if self.moe else None,
            encoder_layers=2 if self.is_encdec else 0,
            num_frames=32 if self.is_encdec else self.num_frames,
            max_position=min(self.max_position, 512),
            num_patches=8 if self.frontend == "vision" else 0,
            window=min(self.window, 64) if self.window else None,
            rwkv_head_dim=32,
            name=self.name + "-reduced",
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)

INPUT_SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training/population hyper-parameters (paper §4 defaults)."""

    population: int = 5
    same_init: bool = True
    optimizer: str = "sgd"  # sgd | adamw
    lr: float = 0.1
    min_lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_steps: int = 0
    total_steps: int = 1000
    batch_size: int = 64
    seq_len: int = 128
    seed: int = 0
    heterogeneous: bool = True  # per-member augmentations/regularization
