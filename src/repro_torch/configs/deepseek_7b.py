"""DeepSeek-7B [arXiv:2401.02954]: llama-architecture dense model."""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        mlp_kind="swiglu",
    )
)
