"""Model configuration schema + registry for the assigned architectures."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attn_kind: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope: str = "rope"  # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()
    attn_window: int = 0  # 0 = global; >0 = sliding-window (local) attn
    logit_softcap: float = 0.0

    # mlp
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # mla (deepseek-v2)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ssm (mamba2 / SSD)
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame positions (stub frontend)
    frontend: str = "none"  # none | audio_stub | vision_stub

    # embeddings / norms
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # training
    max_seq: int = 8192

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP counts (roofline §) --------------------

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        pattern = self.block_pattern or ("attn",)

        def attn_params() -> int:
            if self.attn_kind == "mla":
                qd = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                return (
                    d * qd
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank
                    * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            qo = d * self.n_heads * self.head_dim * 2
            kv = d * self.n_kv_heads * self.head_dim * 2
            return qo + kv

        def mlp_params(width: int) -> int:
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            return mult * d * width

        def layer_params(kind: str, layer_idx: int) -> int:
            if kind == "rec":
                w = self.lru_width or d
                # gate/rec/out projections + conv + RG-LRU gate matrices
                return 3 * d * w + 2 * w * w + 8 * w + mlp_params(ff)
            if kind == "ssm":
                d_in = self.ssm_expand * d
                conv_dim = d_in + 2 * self.ssm_n_groups * self.ssm_d_state
                return (
                    d
                    * (
                        2 * d_in
                        + 2 * self.ssm_n_groups * self.ssm_d_state
                        + d_in // self.ssm_head_dim
                    )
                    + conv_dim * self.ssm_d_conv
                    + d_in * d
                )
            base = attn_params()
            if self.is_moe and layer_idx >= self.first_dense_layers:
                base += (self.n_experts + self.n_shared_experts) * mlp_params(
                    self.moe_d_ff or ff
                ) + d * self.n_experts
            else:
                base += mlp_params(ff)
            return base

        if self.family == "ssm":
            kinds = ["ssm"] * self.n_layers
        elif self.block_pattern:
            kinds = [
                self.block_pattern[i % len(self.block_pattern)]
                for i in range(self.n_layers)
            ]
        else:
            kinds = ["attn"] * self.n_layers
        n += sum(layer_params(k, i) for i, k in enumerate(kinds))
        n += self.encoder_layers * (attn_params() * 2 + mlp_params(ff))
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        moe_ff = self.moe_d_ff or self.d_ff
        per_expert = mult * self.d_model * moe_ff
        moe_layers = self.n_layers - self.first_dense_layers
        inactive = moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — structure preserved (pattern, attn kind,
    GQA ratio, MoE/shared experts, MLA dims scaled)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4 if not cfg.block_pattern else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(
            1, min(cfg.n_kv_heads, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)) or 1
        ),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        max_seq=128,
        param_dtype="float32",
        act_dtype="float32",
    )
    if cfg.is_moe:
        kw.update(
            n_experts=min(cfg.n_experts, 8),
            top_k=min(cfg.top_k, 2),
            moe_d_ff=64,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            first_dense_layers=min(cfg.first_dense_layers, 1),
        )
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    if cfg.family == "ssm":
        kw.update(ssm_d_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16)
    if cfg.block_pattern:
        kw.update(lru_width=128, attn_window=32)
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.rope == "mrope":
        kw.update(mrope_sections=(4, 6, 6))  # sums to head_dim/2 = 16
    return cfg.replace(**kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import config modules lazily so registry fills on first use
    from repro_torch import configs as _c  # noqa

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa

    return sorted(_REGISTRY)
