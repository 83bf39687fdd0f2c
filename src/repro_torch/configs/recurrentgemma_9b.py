"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: hybrid with pattern
(rec, rec, attn) — RG-LRU recurrent blocks + local (2048-window) MQA
attention.  38 layers = 12 scanned pattern units + 2 tail rec layers.
Sub-quadratic: runs long_500k."""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=("rec", "rec", "attn"),
        lru_width=4096,
        attn_window=2048,
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
    )
)
