"""whisper-medium — encoder–decoder audio transformer [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the assignment:
``input_specs`` feeds precomputed 1500-frame embeddings to the encoder.
Learned absolute positions (no rope), per the Whisper architecture.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    pos_kind="learned",
    max_position=32768,  # decode_32k requires a 32k position table
    num_frames=1500,
    frontend="audio",
    source="arXiv:2212.04356 (Whisper medium)",
)
