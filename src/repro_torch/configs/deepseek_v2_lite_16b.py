"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA (kv_lora 512, rope dim
64, nope 128) + fine-grained MoE: 64 routed experts top-6 plus 2 shared,
moe d_ff 1408, first layer dense (d_ff 10944).

Assignment-line note: the line says both "MoE 64e top-6" and "2
shared+160 routed"; 160 routed is the 236B DeepSeek-V2.  We follow the
*Lite* paper: 64 routed + 2 shared (recorded in DESIGN.md §5).
"""

from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab_size=102400,
        attn_kind="mla",
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        mlp_kind="swiglu",
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
    )
)
