"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim 256 (attn dim 4096 !=
d_model 3072), embeddings scaled by sqrt(d_model) and tied, RMSNorm
with (1 + scale) parameterization."""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
    )
)
