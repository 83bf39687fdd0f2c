"""Whisper large-v3 [arXiv:2212.04356]: encoder-decoder ASR transformer.

The conv/mel frontend is a STUB per the assignment: input_specs provides
precomputed (B, 1500, d_model) frame embeddings for the encoder.
32 encoder + 32 decoder layers, full MHA (kv == heads), learned
positions, GELU MLP, LayerNorm.
"""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        encoder_layers=32,
        encoder_seq=1500,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        rope="learned",
        mlp_kind="gelu",
        frontend="audio_stub",
        max_seq=4096,
        norm_eps=1e-5,
    )
)
