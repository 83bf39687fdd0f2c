"""Qwen2-VL-7B [arXiv:2409.12191]: VLM backbone with M-RoPE.

Vision frontend is a STUB per the assignment (text-token stream; patch
embeddings would merge into the same stream).  M-RoPE: rotary dims are
split into (temporal, height, width) sections [16, 24, 24] with three
position streams (all equal for text).
"""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        rope="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        mlp_kind="swiglu",
        frontend="vision_stub",
    )
)
