"""Grok-1 314B [hf:xai-org/grok-1]: 64-layer MoE, 8 experts top-2,
GQA kv=8, attention logit softcap 30."""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        mlp_kind="geglu",  # grok-1 release: linear/linear_v/linear_1 (gated)
        n_experts=8,
        top_k=2,
        moe_d_ff=32768,
        logit_softcap=30.0,
        rope_theta=10_000.0,
    )
)
