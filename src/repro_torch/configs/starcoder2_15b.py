"""StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, RoPE, plain GELU MLP.

(The paper's canonical AMQ use case — code dedup at dataset scale —
runs through this arch's data pipeline in examples/dedup_pipeline.py.)
"""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        mlp_kind="gelu",
        norm_eps=1e-5,
    )
)
