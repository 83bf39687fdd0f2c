"""Roofline terms of a step, and the H100's least times for the work.

The port of ``repro.launch.roofline``.  Three terms per (arch x shape x
mesh), in seconds:

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The rates are the NVIDIA H100 SXM data sheet's (in place of the TPU
v5e's of the reference).  The port has no compiled program to read: the
dry run (``launch/dryrun.py``) counts a step's flops as it runs on the
``meta`` device, and on a placed mesh the bytes of every collective the
step issues, by kind, in the reference's output-shape convention
(``dryrun.StepMeter``, where the reference parses the HLO with
``collective_bytes``); the collective term is their total over
``LINK_BW``, one card's NVLink.  The memory term is the bytes a step must move, whatever code runs it
(``step_bytes``: ``prefill_bytes``, ``decode_bytes``, ``train_bytes``),
the same counts that ``prefill_bound_ms``, ``decode_bound_ms`` and
``train_bound_ms`` put over the HBM rate for the serving and training
steps ``chip_smoke.py`` times.  ``kernel_roofline`` takes a kernel's
bytes and flops as ``chip_smoke.py`` counts them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..models import model
from ..models import schema as model_schema
from ..models.transformer import layer_kinds

# NVIDIA H100 SXM per-card rates (data sheet)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core peak
HBM_BW = 3.35e12  # HBM3, bytes/s
# NVLink 4, bytes/s one way: a data sheet number that one card cannot
# measure (a mesh of more than one card waits for a machine with two); the
# dry run's collective term
LINK_BW = 450e9


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    model_flops: float = 0.0  # analytic 6·N·D (or serve equivalent)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three engines."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / counted flops (global) — remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Roofline MFU: useful model FLOPs over peak at the step-time
        lower bound."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "step_time_lb_s": self.step_time,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_mfu": self.mfu,
            "chips": self.chips,
        }


def kernel_roofline(bytes_moved: float, flops: float = 0.0) -> Roofline:
    """One kernel on one card: the bytes it must move (each input read
    once, each output written once) and the operations it must do, as
    ``chip_smoke.py`` counts them; no collectives.  ``t_memory`` is the
    least time of a bandwidth-bound kernel."""
    return Roofline(flops=float(flops), bytes_accessed=float(bytes_moved), coll_bytes=0.0,
                    chips=1)


def model_flops_estimate(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Analytic useful FLOPs: 6·N_active·D for training, 2·N_active·D
    (+ attention KV term) for serving."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        base = 6.0 * n_active * batch * seq
        # attention score/value FLOPs (causal ~ S^2/2), fwd+bwd (x3)
        if cfg.attn_kind != "none":
            attn = (
                cfg.n_layers
                * batch
                * (seq * seq / 2)
                * cfg.n_heads
                * cfg.head_dim
                * 2
                * 2
                * 3
            )
            base += attn
        return base
    if shape_kind == "prefill":
        base = 2.0 * n_active * batch * seq
        if cfg.attn_kind != "none":
            base += (
                cfg.n_layers * batch * (seq * seq / 2) * cfg.n_heads * cfg.head_dim * 4
            )
        return base
    # decode: one token; attention reads the whole cache
    base = 2.0 * n_active * batch
    if cfg.attn_kind != "none":
        kv_len = seq if not cfg.attn_window else min(seq, cfg.attn_window)
        base += cfg.n_layers * batch * kv_len * cfg.n_heads * cfg.head_dim * 4
    return base


# ---------------------------------------------------------------------------
# Least times of the serving and training steps on one card
# ---------------------------------------------------------------------------


def schema_params(cfg, keep) -> int:
    """The parameters of the schema's leaves whose path ``keep`` accepts."""
    return sum(math.prod(p.shape) for path, p in model_schema.tree_items(model.schema(cfg))
               if keep(path))


def gathered(path) -> bool:
    """A table that a token or frame gathers a row of: the position tables,
    and the token embedding where the unembedding does not reuse it."""
    return path[-1] == "pos_embed" or path == ("tok_embed",)


def mm_params(cfg) -> int:
    """The decoder's parameters that take part in a matrix product: all but
    the gathered tables (a tied embedding is the unembedding's product)
    and the encoder."""
    return schema_params(cfg, lambda path: path[0] != "encoder" and not (
        gathered(path) and not (cfg.tie_embeddings and path == ("tok_embed",))))


def encoder_mm_params(cfg) -> int:
    """The encoder's parameters in its products: all but its position table."""
    return schema_params(cfg, lambda path: path[0] == "encoder" and path[-1] != "pos_embed")


def llm_params(cfg) -> int:
    return schema_params(cfg, lambda path: True)


def routed_params(cfg) -> int:
    """The routed experts' parameters, all MoE layers (0 for a dense model)."""
    return schema_params(cfg, lambda path: "moe" in path and path[-1] in ("wi", "wg", "wo"))


def moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0


def expert_params(cfg) -> float:
    """One routed expert's parameters in one MoE layer."""
    return routed_params(cfg) / (moe_layers(cfg) * cfg.n_experts) if cfg.is_moe else 0.0


def kind_layers(cfg) -> dict:
    """The decoder's layers of each sub-block kind."""
    kinds = layer_kinds(cfg)
    return {k: kinds.count(k) for k in set(kinds)}


def attn_flops_a_pair(cfg) -> int:
    """Flops of QK^T and PV for one query-key pair in one layer: GQA's
    4 H Dh; MLA's fewer of its two forms, the absorbed 2 H (2 kv_lora_rank +
    rope dim) and the up-projected 2 H (nope + rope + v_head_dim), whose
    up-projection of each cached position is among the 2 N flops a token."""
    if cfg.attn_kind == "mla":
        absorbed = 2 * cfg.kv_lora_rank + cfg.qk_rope_dim
        projected = cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
        return 2 * cfg.n_heads * min(absorbed, projected)
    return 4 * cfg.n_heads * cfg.head_dim


def cache_bytes_a_position(cfg) -> int:
    """bf16 cache bytes of one position in one layer: GQA's K and V, MLA's
    latent and rope key."""
    if cfg.attn_kind == "mla":
        return 2 * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    return 2 * 2 * cfg.n_kv_heads * cfg.head_dim


def causal_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs of a causal attention over S positions, each query
    seeing at most ``window`` keys (0: all before it)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def ssd_flops_a_row(cfg, S: int) -> int:
    """Flops of one Mamba-2 layer's SSD over S positions (one row), beyond
    its projections: the intra-chunk causal pairs, each C_i . B_j (2 G N)
    and its weighted sum of values (2 H P), over the padded chunks; the
    chunk states and the inter-chunk term, 2 H P N each a position."""
    d_in = cfg.ssm_expand * cfg.d_model
    H, P = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    nc = -(-S // Q)
    pair = 2 * cfg.ssm_n_groups * cfg.ssm_d_state + 2 * H * P
    return nc * (Q * (Q + 1) // 2) * pair + nc * Q * 4 * H * P * cfg.ssm_d_state


def state_bytes_a_layer(cfg, kind: str, B: int) -> int:
    """bf16 bytes of one ``ssm`` or ``rec`` layer's decode state and conv
    window at B rows (a step reads and writes each once)."""
    if kind == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
        return 2 * B * (d_in * N + (K - 1) * (d_in + 2 * G * N))
    w = cfg.lru_width or cfg.d_model
    return 2 * B * (w + 3 * w)


def prefill_bound_ms(cfg, B: int, S: int) -> tuple:
    """The least time for a prefill of B x S tokens: 2 N flops a token (N the
    active ``mm_params``: dense and shared weights, the router, top_k / E of
    the routed experts, a tied unembedding) plus the attention's QK^T and
    PV over its pairs (causal, at most ``attn_window`` keys a query;
    whisper's cross-attention S x encoder_seq), SSD's chunk work
    (``ssd_flops_a_row``) and an encoder's 2 N flops a frame and its
    non-causal attention, over the card's dense bf16 peak, or the weights
    read once over the HBM rate if that is longer.  Returns (ms, flops,
    what bounds it)."""
    routed = routed_params(cfg)
    active = mm_params(cfg) - routed + (routed * cfg.top_k / cfg.n_experts if routed else 0)
    layers = kind_layers(cfg)
    pair = attn_flops_a_pair(cfg)
    attn = pair * B * causal_pairs(S, cfg.attn_window) * layers.get("attn", 0)
    attn += pair * B * (causal_pairs(S) + S * cfg.encoder_seq) * layers.get("xattn", 0)
    attn += B * ssd_flops_a_row(cfg, S) * layers.get("ssm", 0)
    frames = B * cfg.encoder_seq
    encoder = 2 * encoder_mm_params(cfg) * frames + pair * B * cfg.encoder_seq**2 * cfg.encoder_layers
    flops = 2 * active * B * S + attn + encoder
    ops_ms = flops / PEAK_FLOPS * 1e3
    bytes_ms = prefill_bytes(cfg) / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), flops, "operations" if ops_ms >= bytes_ms else "bytes"


def prefill_bytes(cfg) -> int:
    """The bytes a prefill must move: the weights, bf16, read once."""
    return 2 * llm_params(cfg)


def least_picked(cfg) -> int:
    """The fewest routed experts a decode step can pick over all MoE
    layers: each token picks ``top_k`` distinct ones a layer."""
    return cfg.top_k * moe_layers(cfg)


def decode_bytes(cfg, B: int, cached: float, picked: int = 0) -> float:
    """The bytes one decode step of B rows over ``cached`` valid cache
    positions a row must move: the decoder's weights in products but the
    routed experts, the ``picked`` routed experts (over all MoE layers)
    that the step's tokens pick, B rows of the token table (and one of a
    position table), and the caches, each read once.  An attention layer
    reads ``min(cached, attn_window)`` positions, an ``xattn`` layer
    ``cached`` and the encoder_seq cross positions; an ``ssm`` or ``rec``
    layer reads and writes its fixed state and conv window, and nothing a
    cached position."""
    layers = kind_layers(cfg)
    seen = min(cached, cfg.attn_window) if cfg.attn_window else cached
    kv = B * seen * layers.get("attn", 0) * cache_bytes_a_position(cfg)
    kv += B * (cached + cfg.encoder_seq) * layers.get("xattn", 0) * cache_bytes_a_position(cfg)
    kv += sum(2 * state_bytes_a_layer(cfg, k, B) * layers.get(k, 0) for k in ("ssm", "rec"))
    weights = mm_params(cfg) - routed_params(cfg) + picked * expert_params(cfg)
    rows = B * cfg.d_model + (cfg.d_model if cfg.rope == "learned" else 0)
    return 2 * weights + 2 * rows + kv


def decode_bound_ms(cfg, B: int, cached: float, picked: int = 0) -> float:
    """The least time for one decode step: ``decode_bytes`` over the HBM
    rate."""
    return decode_bytes(cfg, B, cached, picked) / HBM_BW * 1e3


def train_bytes(state_bytes: float, param_bytes: float) -> float:
    """The bytes a train step must move: the state read and written once,
    and the gradients, of the params' size, read once."""
    return 2 * state_bytes + param_bytes


def step_bytes(cfg, kind: str, B: int, S: int, state_bytes: float = 0,
               param_bytes: float = 0) -> float:
    """The bytes a step of ``kind`` at B x S must move, on one device: a
    decode over S cached positions a row picking ``least_picked`` experts,
    a prefill, or a train step over a state of ``state_bytes`` holding
    ``param_bytes`` of params."""
    if kind == "train":
        return train_bytes(state_bytes, param_bytes)
    if kind == "prefill":
        return prefill_bytes(cfg)
    return decode_bytes(cfg, B, S, least_picked(cfg))


def train_bound_ms(cfg, B: int, S: int, sizes: tuple) -> tuple:
    """The least time for a train step of B x S tokens: three times the
    prefill's flops (``prefill_bound_ms``: 2 N a token for the N parameters
    in products, attention, SSD, encoder; the backward pass takes twice the
    forward's) over the dense bf16 peak, or the optimizer's bytes (the state
    read and written once, the gradients, of the params' size, read once)
    over the HBM rate if that is longer.  ``sizes``: ``state_bytes``.
    Returns (ms, what bounds it)."""
    _, flops, _ = prefill_bound_ms(cfg, B, S)
    ops_ms = 3 * flops / PEAK_FLOPS * 1e3
    bytes_ms = train_bytes(*sizes) / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
