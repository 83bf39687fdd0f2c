"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD (state-space
duality) stack; the only pure-SSM arch in the pool — runs long_500k."""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,  # attention unused
        n_kv_heads=1,
        head_dim=1,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        rope="none",
        ssm_d_state=128,
        ssm_d_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_n_groups=1,
        ssm_chunk=256,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
)
