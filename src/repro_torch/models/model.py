"""Model assembly: parameter schema, forward, prefill, decode.

The port of ``repro.models.model``:

  schema(cfg)                  -> Param tree (every architecture; data only)
  init(cfg, seed, device)      -> random params, on the card unless asked
  abstract(cfg)                -> params on the ``meta`` device (no memory)
  partition_specs(cfg, rules)  -> (mesh, spec) mirroring params
  partition_pspecs(cfg, rules) -> partition specs (tuples) mirroring params
  place(params, cfg, rules)    -> params as DTensors on the rules' device mesh
  forward(params, cfg, batch)  -> (logits, collected, aux)
  loss_fn(params, cfg, batch)  -> (loss, metrics)
  prefill(params, cfg, batch)  -> (logits_last, cache)
  decode_step(params, cfg, cache, tokens) -> (logits, cache)
  init_cache(cfg, batch, ctx)  -> empty decode cache (pos = 0)
  from_numpy(cfg, tree) / to_numpy(params) -> the JAX package's params

Params and caches are nested dicts of tensors with the reference's paths,
the units' leaves stacked on a leading layer axis, the leading dense
layers (``prefix_{i}``) and the remainder layers (``tail_{i}``)
unstacked.  ``forward`` and the decode path apply every family: the
decoders with GQA or MLA attention and a dense MLP or MoE, the Mamba-2
SSM, the Griffin hybrid (RG-LRU and windowed attention) and the Whisper
encoder-decoder (``batch["frames"]`` through ``_encode``).
``decode_step`` writes the cache in place, where the reference donates
it, and reads nothing back to the host: the position stays a device
scalar.  On placed params and caches (DTensors, :func:`place` and
``serve_step.place_cache``) under the rules of their mesh, the same code
runs on the mesh; each rank writes the decode deltas into its own shard
of the cache.  ``loss_fn`` is the train step's objective: the streamed
cross-entropy (``_streamed_xent``) plus the MoE balance loss; with
``remat`` each unit, encoder layer and cross-entropy chunk recomputes its
activations in the backward pass (``transformer.remat_call``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import sharding as shd
from ..core.quotient_filter import resolve_device
from ..sharding import constrain
from . import schema as S
from .attention import gqa_attention, project_heads
from .layers import embed_tokens, mlp, unembed
from .transformer import (
    apply_unit,
    layer_kinds,
    norm,
    remat_call,
    scan_units,
    split_layers,
    unit_pattern,
    unstack,
)

Param = S.Param


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _norm_schema(cfg, dim=None):
    d = dim or cfg.d_model
    if cfg.is_encoder_decoder:  # whisper: LayerNorm
        return {
            "scale": Param((d,), ("embed",), "ones"),
            "bias": Param((d,), ("embed",), "zeros"),
        }
    return {
        "scale": Param((d,), ("embed",), "ones" if not cfg.embed_scale else "zeros")
    }


def _attn_schema(cfg):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": Param((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": Param((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": Param((H, Dh, d), ("heads", "head_dim", "embed"), scale=0.02),
    }
    if cfg.qk_norm:
        out["q_norm"] = Param((Dh,), (None,), "ones")
        out["k_norm"] = Param((Dh,), (None,), "ones")
    return out


def _mla_schema(cfg):
    d, H = cfg.d_model, cfg.n_heads
    nope, rdim, vdim, lora = (
        cfg.qk_nope_dim,
        cfg.qk_rope_dim,
        cfg.v_head_dim,
        cfg.kv_lora_rank,
    )
    return {
        "wq": Param((d, H, nope + rdim), ("embed", "heads", "qk_dim")),
        "w_dkv": Param((d, lora + rdim), ("embed", None)),
        "kv_norm": Param((lora,), (None,), "ones"),
        "w_uk": Param((lora, H, nope), (None, "heads", "qk_dim")),
        "w_uv": Param((lora, H, vdim), (None, "heads", "qk_dim")),
        "wo": Param((H, vdim, d), ("heads", "qk_dim", "embed"), scale=0.02),
    }


def _mlp_schema(cfg, width=None):
    d, ff = cfg.d_model, width or cfg.d_ff
    out = {
        "wi": Param((d, ff), ("embed", "ffn")),
        "wo": Param((ff, d), ("ffn", "embed")),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out["wg"] = Param((d, ff), ("embed", "ffn"))
    return out


def _moe_schema(cfg):
    d, E = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    out = {
        "router": Param((d, E), ("embed", None), scale=0.02),
        "wi": Param((E, d, ff), ("experts", "embed", "expert_ffn")),
        "wo": Param((E, ff, d), ("experts", "expert_ffn", "embed")),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out["wg"] = Param((E, d, ff), ("experts", "embed", "expert_ffn"))
    if cfg.n_shared_experts:
        w = cfg.n_shared_experts * ff
        out["shared_wi"] = Param((d, w), ("embed", "ffn"))
        out["shared_wo"] = Param((w, d), ("ffn", "embed"))
        if cfg.mlp_kind in ("swiglu", "geglu"):
            out["shared_wg"] = Param((d, w), ("embed", "ffn"))
    return out


def _ssm_schema(cfg):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
    H = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * G * N
    return {
        "in_proj": Param((d, 2 * d_in + 2 * G * N + H), ("embed", "ssm_inner")),
        "conv_w": Param((K, conv_dim), (None, "ssm_inner"), scale=0.2),
        "conv_b": Param((conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": Param((H,), (None,), "const", scale=1.39),  # A ~ -4
        "dt_bias": Param((H,), (None,), "const", scale=-4.6),  # dt ~ 0.01
        "D": Param((H,), (None,), "ones"),
        "out_norm": Param((d_in,), ("ssm_inner",), "ones"),
        "out_proj": Param((d_in, d), ("ssm_inner", "embed")),
    }


def _rec_schema(cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_gate": Param((d, w), ("embed", "lru")),
        "w_rec": Param((d, w), ("embed", "lru")),
        "conv_w": Param((4, w), (None, "lru"), scale=0.2),
        "conv_b": Param((w,), ("lru",), "zeros"),
        "w_a": Param((w, w), (None, "lru")),
        "b_a": Param((w,), ("lru",), "zeros"),
        "w_x": Param((w, w), (None, "lru")),
        "b_x": Param((w,), ("lru",), "zeros"),
        "lam": Param((w,), (None,), "const", scale=1.0),
        "w_out": Param((w, d), ("lru", "embed")),
    }


def _subblock_schema(cfg, kind: str, moe_layer: bool):
    if kind == "ssm":
        return {"norm": _norm_schema(cfg), "ssm": _ssm_schema(cfg)}
    if kind == "rec":
        return {
            "norm": _norm_schema(cfg),
            "rec": _rec_schema(cfg),
            "mlp_norm": _norm_schema(cfg),
            "mlp": _mlp_schema(cfg),
        }
    if kind == "xattn":
        return {
            "norm1": _norm_schema(cfg),
            "self_attn": _attn_schema(cfg),
            "norm2": _norm_schema(cfg),
            "cross_attn": _attn_schema(cfg),
            "norm3": _norm_schema(cfg),
            "mlp": _mlp_schema(cfg),
        }
    attn = _mla_schema(cfg) if cfg.attn_kind == "mla" else _attn_schema(cfg)
    out = {"norm": _norm_schema(cfg), "attn": attn, "mlp_norm": _norm_schema(cfg)}
    if moe_layer:
        out["moe"] = _moe_schema(cfg)
    else:
        out["mlp"] = _mlp_schema(cfg)
    return out


def _unit_schema(cfg, pat, moe_flags):
    return {
        f"b{i}": _subblock_schema(cfg, k, moe_flags[i]) for i, k in enumerate(pat)
    }


def _stack(schema_tree, n: int):
    return S.tree_map(
        lambda p: Param((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype),
        schema_tree,
    )


def moe_flags_for(cfg, pat) -> tuple:
    return tuple(cfg.is_moe for _ in pat)


def schema(cfg) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    pat = unit_pattern(cfg)
    prefix, n_units, tail = split_layers(cfg)
    flags = moe_flags_for(cfg, pat)

    out: dict[str, Any] = {
        "tok_embed": Param((V, d), ("vocab", "embed"), "normal"),
        "final_norm": _norm_schema(cfg),
        "layers": _stack(_unit_schema(cfg, pat, flags), n_units),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = Param((d, V), ("embed", "vocab"))
    if cfg.rope == "learned":
        out["pos_embed"] = Param((cfg.max_seq, d), (None, "embed"), "normal")
    for i in range(prefix):  # unscanned leading dense layers (dsv2)
        out[f"prefix_{i}"] = _subblock_schema(cfg, layer_kinds(cfg)[i], False)
    for i, k in enumerate(tail):  # remainder layers (recurrentgemma 38 % 3)
        out[f"tail_{i}"] = _subblock_schema(cfg, k, cfg.is_moe)
    if cfg.is_encoder_decoder:
        enc_unit = {
            "b0": {
                "norm1": _norm_schema(cfg),
                "self_attn": _attn_schema(cfg),
                "norm3": _norm_schema(cfg),
                "mlp": _mlp_schema(cfg),
            }
        }
        out["encoder"] = {
            "pos_embed": Param((cfg.encoder_seq, d), (None, "embed"), "normal"),
            "layers": _stack(enc_unit, cfg.encoder_layers),
            "final_norm": _norm_schema(cfg),
        }
    return out


def init(cfg, seed: int = 0, device=None):
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless asked; without one this raises)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return S.init_params(schema(cfg), gen, cfg.param_dtype)


def abstract(cfg):
    return S.abstract_params(schema(cfg), cfg.param_dtype)


def partition_specs(cfg, rules):
    return S.param_specs(schema(cfg), rules)


def partition_pspecs(cfg, rules):
    return S.param_pspecs(schema(cfg), rules)


def place(params, cfg, rules):
    """The params as DTensors on the device mesh of ``rules.mesh``, each
    leaf by its ``partition_pspecs`` spec.  Every rank must pass the same
    whole params (``init`` on one device from one seed does)."""
    return shd.place(params, partition_pspecs(cfg, rules), rules.mesh)


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------


def from_numpy(cfg, tree, device=None):
    """Params from the JAX package's params as nested dicts of numpy arrays.

    Every leaf's path, shape and dtype must be the schema's.  bfloat16
    leaves may come as numpy bfloat16 arrays (what ``np.asarray`` of a JAX
    array gives) or as their uint16 bit patterns (what :func:`to_numpy`
    gives); either is read by its bits, with no bfloat16 type in numpy."""
    device = resolve_device(device)

    def build(sch, tr, path):
        if isinstance(sch, dict):
            if not isinstance(tr, dict) or set(tr) != set(sch):
                got = sorted(tr) if isinstance(tr, dict) else type(tr).__name__
                raise ValueError(f"{'/'.join(path) or 'params'}: keys {got}, want {sorted(sch)}")
            return {k: build(sch[k], tr[k], path + (k,)) for k in sch}
        name = "/".join(path)
        a = np.asarray(tr)
        if a.shape != sch.shape:
            raise ValueError(f"{name}: shape {a.shape}, want {sch.shape}")
        dtype = sch.dtype or cfg.param_dtype
        if dtype == "bfloat16" and a.dtype.name in ("bfloat16", "uint16"):
            a = a.view(np.int16)
        elif a.dtype.name != dtype:
            raise ValueError(f"{name}: dtype {a.dtype.name}, want {dtype}")
        t = torch.from_numpy(np.array(a))  # a copy: the caller's arrays stay theirs
        return (t.view(torch.bfloat16) if dtype == "bfloat16" else t).to(device)

    return build(schema(cfg), tree, ())


def to_numpy(params):
    """The params as nested dicts of numpy arrays, bfloat16 leaves as their
    uint16 bit patterns (numpy has no bfloat16)."""

    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return S.tree_map(one, params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _encoder_layer(p, x, cfg, pos):
    h, _ = gqa_attention(
        p["self_attn"], norm(p["norm1"], x, cfg), cfg, pos, causal=False, use_rope=False
    )
    x = x + h
    return x + mlp(p["mlp"], norm(p["norm3"], x, cfg), cfg.mlp_kind)


def _encode(params, cfg, frames, remat=True):
    """frames: (B, enc_seq, d), precomputed frame embeddings (the stub
    front end).  The encoder's non-causal layers, no RoPE, each under
    ``remat_call``; its own learned positions."""
    enc = params["encoder"]
    x = frames + enc["pos_embed"][None, : frames.shape[1], :].to(frames.dtype)
    B, Se = frames.shape[:2]
    pos = torch.arange(Se, dtype=torch.int32, device=frames.device).expand(B, Se)
    layers = enc["layers"]["b0"]
    for p in unstack(layers, next(S.tree_items(layers))[1].shape[0]):
        x = remat_call(_encoder_layer, remat, p, x, cfg, pos)
    return norm(enc["final_norm"], x, cfg)


def _embed_in(params, cfg, tokens, pos=None):
    """Token embeddings in the activations' dtype, plus the learned
    positions (whisper) at 0..S-1, or at the decode position ``pos`` (a
    device scalar).  A position past the table reads its last row, as
    the reference's clamping gather does.  The rows are gathered by
    ``sharding.take_rows`` (on a mesh each rank picks its own rows from
    the whole table; ``index_select``'s backward returned a DTensor whose
    shard was the whole table)."""
    x = embed_tokens(params["tok_embed"], tokens, cfg.embed_scale, cfg.d_model)
    x = x.to(getattr(torch, cfg.act_dtype))
    if cfg.rope == "learned":
        if pos is None:
            pos = torch.arange(tokens.shape[1], device=tokens.device)
        idx = torch.clamp(pos, max=cfg.max_seq - 1).to(torch.int64).reshape(-1)
        x = x + shd.take_rows(params["pos_embed"], idx)[None].to(x.dtype)
    return x


def _apply_stack(params, cfg, x, positions, *, mode, cache=None, enc_out=None,
                 mrope_positions=None, remat=True):
    """The leading dense layers unlooped, the looped units (each under
    ``remat_call``), then the remainder layers unlooped.  Returns (x, collected, aux):
    collected["prefix_{i}"] / ["tail_{i}"] a single layer's K/V or state
    (prefill) or delta (decode), collected["layers"] the units', stacked;
    aux the MoE balance losses summed."""
    pat = unit_pattern(cfg)
    prefix, _, tail = split_layers(cfg)
    kinds = layer_kinds(cfg)
    collected, aux = {}, 0.0

    def single(grp, kind, x, moe):
        x, col, a = apply_unit(
            (kind,), {"b0": params[grp]}, x, cfg, positions, mode=mode,
            cache=None if cache is None else {"b0": cache[grp]}, enc_out=enc_out,
            mrope_positions=mrope_positions, moe_flags=(moe,),
        )
        if col is not None:
            collected[grp] = col["b0"]
        return x, a

    for i in range(prefix):
        x, a = single(f"prefix_{i}", kinds[i], x, False)
        aux = aux + a
    x, col, a = scan_units(
        pat, params["layers"], x, cfg, positions, mode=mode,
        cache=None if cache is None else cache["layers"], enc_out=enc_out,
        mrope_positions=mrope_positions, moe_flags=moe_flags_for(cfg, pat), remat=remat,
    )
    if col is not None:
        collected["layers"] = col
    aux = aux + a
    for i, kind in enumerate(tail):
        x, a = single(f"tail_{i}", kind, x, cfg.is_moe)
        aux = aux + a
    return x, collected, aux


def _text_positions(cfg, positions, mrope_positions):
    """The three M-RoPE streams, all equal to the text positions, unless given."""
    if cfg.rope == "mrope" and mrope_positions is None:
        return positions[None].expand(3, *positions.shape)
    return mrope_positions


def _trunk(params, cfg, batch, mode, remat):
    """Embedding, encoder, layers and the final norm: (x, collected, aux)."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    x = constrain(_embed_in(params, cfg, tokens), "batch", "seq", "embed")
    positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device).expand(B, Sq)
    mrope_positions = _text_positions(cfg, positions, batch.get("mrope_positions"))
    enc_out = (
        _encode(params, cfg, batch["frames"], remat=remat) if cfg.is_encoder_decoder else None
    )
    x, collected, aux = _apply_stack(
        params, cfg, x, positions, mode=mode, enc_out=enc_out,
        mrope_positions=mrope_positions, remat=remat,
    )
    if mode == "prefill" and enc_out is not None:
        collected["enc_out"] = enc_out
    x = norm(params["final_norm"], x, cfg)
    if not torch.is_tensor(aux):  # no MoE layer: a device zero, with no copy from the host
        aux = x.new_zeros((), dtype=torch.float32)
    return x, collected, aux


def forward(params, cfg, batch, *, mode="train", remat=True):
    """batch: dict(tokens (B,S) [, frames, mrope_positions]).

    Returns (logits, collected, aux): logits at every position; aux, the
    MoE balance losses summed over the layers (float32; 0 without MoE).
    In prefill an encoder-decoder's collected also holds the encoder's
    output, ``collected["enc_out"]``, for the cross-attention cache."""
    x, collected, aux = _trunk(params, cfg, batch, mode, remat)
    logits = constrain(unembed(params, x, cfg.tie_embeddings), "batch", "seq", "vocab")
    return logits, collected, aux


def _xent_chunk(params, cfg, xi, ti):
    """One chunk's (sum of nll, tokens): a float32 unembedding and
    logsumexp, the target's logit gathered at ``max(t, 0)`` (torch's
    gather raises on a negative index, where the reference's clamps),
    positions with ``t < 0`` masked out.  On a mesh the vocab dim is made
    whole first (``sharding.unshard``): DTensor's vocab-parallel gather
    fails on these (B, chunk, V) logits."""
    logits = shd.unshard(unembed(params, xi, cfg.tie_embeddings).float(), -1)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp(ti, min=0).to(torch.int64)[..., None])[..., 0]
    mask = (ti >= 0).float()
    return torch.sum((logz - tgt) * mask), torch.sum(mask)


def _streamed_xent(params, cfg, x, targets, chunk: int = 256, remat=True):
    """Chunked softmax cross-entropy over the sequence dim.

    The full (B, S, V) float32 logits are the largest train buffer;
    computing the unembedding and logsumexp a chunk at a time, each chunk
    under ``remat_call``, keeps one chunk's logits live in either pass.
    ``chunk`` halves until it divides S.  Returns (sum_nll, n_tokens)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    parts = [
        remat_call(_xent_chunk, remat, params, cfg, x[:, c : c + chunk], targets[:, c : c + chunk])
        for c in range(0, S, chunk)
    ]
    return torch.stack([p[0] for p in parts]).sum(), torch.stack([p[1] for p in parts]).sum()


def loss_fn(params, cfg, batch, *, remat=True, aux_weight=0.01):
    """batch: dict(tokens, targets (B, S) [, frames, mrope_positions]);
    a target below 0 is masked.  Returns (total, {"loss", "aux",
    "tokens"}): loss the mean nll over the unmasked targets, total =
    loss + aux_weight * aux."""
    x, _, aux = _trunk(params, cfg, batch, "train", remat)
    nll, ntok = _streamed_xent(params, cfg, x, batch["targets"], remat=remat)
    loss = nll / torch.clamp(ntok, min=1.0)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": ntok}


# ---------------------------------------------------------------------------
# Decode: cache init, prefill, single-token step
# ---------------------------------------------------------------------------


def _subblock_cache(cfg, kind: str, lead: tuple, B: int, ctx: int, dtype, device):
    """Empty cache for one sub-block; ``lead`` is (n_units,) for the looped
    units' stacked leaves, () for a leading or remainder layer.

    ``ssm``: the conv window (B, K-1, d_in + 2GN) and the state (B, H, P, N);
    ``rec``: the conv window (B, 3, w) and the state (B, w); ``xattn``: a
    ``self`` ring of ``ctx`` slots and a ``cross`` cache of the encoder's
    ``encoder_seq`` slots; ``attn``: K/V, or MLA's latents ``c_kv`` and
    ``k_rope``, in a ring of ``min(ctx, attn_window)`` slots.  Rings carry
    their slots' positions, ``kpos``."""

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    def kpos(length, fill):
        return torch.full(lead + (B, length), fill, dtype=torch.int32, device=device)

    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    if kind == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
        H = d_in // cfg.ssm_head_dim
        return {"ssm": {"conv": zeros(B, K - 1, d_in + 2 * G * N),
                        "state": zeros(B, H, cfg.ssm_head_dim, N)}}
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return {"rec": {"conv": zeros(B, 3, w), "state": zeros(B, w)}}
    if kind == "xattn":
        Se = cfg.encoder_seq
        return {
            "self": {"k": zeros(B, ctx, KV, Dh), "v": zeros(B, ctx, KV, Dh), "kpos": kpos(ctx, -1)},
            "cross": {"k": zeros(B, Se, KV, Dh), "v": zeros(B, Se, KV, Dh), "kpos": kpos(Se, 0)},
        }
    length = min(ctx, cfg.attn_window) if cfg.attn_window else ctx
    if cfg.attn_kind == "mla":
        leaves = {"c_kv": zeros(B, length, cfg.kv_lora_rank),
                  "k_rope": zeros(B, length, cfg.qk_rope_dim)}
    else:
        leaves = {"k": zeros(B, length, KV, Dh), "v": zeros(B, length, KV, Dh)}
    leaves["kpos"] = kpos(length, -1)
    return {"attn": leaves}


def init_cache(cfg, B: int, ctx: int, dtype=None, device=None):
    device = resolve_device(device)
    dt = getattr(torch, dtype or cfg.act_dtype)
    pat = unit_pattern(cfg)
    prefix, n_units, tail = split_layers(cfg)
    kinds = layer_kinds(cfg)
    cache: dict[str, Any] = {
        "layers": {
            f"b{i}": _subblock_cache(cfg, k, (n_units,), B, ctx, dt, device)
            for i, k in enumerate(pat)
        },
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    for i in range(prefix):
        cache[f"prefix_{i}"] = _subblock_cache(cfg, kinds[i], (), B, ctx, dt, device)
    for i, k in enumerate(tail):
        cache[f"tail_{i}"] = _subblock_cache(cfg, k, (), B, ctx, dt, device)
    return cache


def prefill(params, cfg, batch, *, headroom: int = 128):
    """Full-sequence forward that also fills a decode cache.

    ``headroom`` extra KV slots let decoding continue past the prompt
    without wrapping onto cached context."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    logits, collected, _ = forward(params, cfg, batch, mode="prefill", remat=False)
    cache = init_cache(cfg, B, Sq + headroom, cfg.act_dtype, tokens.device)
    enc_out = collected.pop("enc_out", None)
    cache = _fill_cache_from_collected(cache, collected, Sq)
    if enc_out is not None:
        _fill_cross(cache["layers"]["b0"]["cross"], params["layers"]["b0"]["cross_attn"], enc_out)
    cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], cache


def _ring_gather(kv, S, length, axis: int = 1):
    """Place K/V with S positions on ``axis`` into a length-L ring keyed by p % L.

    Slot j holds the latest position p < S with p % L == j (or is empty
    when L >= S and j >= S). Returns (cache_kv, kpos)."""
    device = kv.device
    if length >= S:
        pad = [0, 0] * (kv.ndim - 1 - axis) + [0, length - S]
        idx = torch.cat([
            torch.arange(S, dtype=torch.int32, device=device),
            torch.full((length - S,), -1, dtype=torch.int32, device=device),
        ])
        if length == S:  # no empty slot: the K/V as they are, copied
            return kv.clone(memory_format=torch.contiguous_format), idx
        return torch.nn.functional.pad(kv, pad), idx
    offs = (torch.arange(length, device=device) - S) % length
    idx = (S - length + offs).to(torch.int32)
    return torch.index_select(kv, axis, idx), idx


def _fill_unit_cache(cache_b, col_b, S):
    """Fill one sub-block's cache from what its prefill collected: an
    ``ssm``/``rec`` state and conv window taken as the new leaves (on a
    mesh, placed as they come out); K/V (or MLA's
    ``c_kv``, ``k_rope``) ring-gathered, with the slots' positions.  The
    positions run along the cache's ring axis: 2 for the units' stacked
    leaves (n_units, B, S, ...), 1 for a single layer's (B, S, ...)."""
    for kind in ("ssm", "rec"):
        if kind in col_b:
            sub = cache_b[kind]
            for name, leaf in col_b[kind].items():
                sub[name] = leaf.to(sub[name].dtype).contiguous()
            return cache_b
    sub = cache_b["self"] if "self_kv" in col_b else cache_b["attn"]
    axis = sub["kpos"].ndim - 1
    length = sub["kpos"].shape[axis]
    names = ("c_kv", "k_rope") if "c_kv" in sub else ("k", "v")
    for name, leaf in zip(names, col_b.get("self_kv", col_b.get("kv"))):
        sub[name], idx = _ring_gather(leaf, S, length, axis=axis)
    sub["kpos"] = idx.expand(sub["kpos"].shape).contiguous()
    return cache_b


def _fill_cross(cross, p_cross, enc_out):
    """The units' cross-attention cache from the encoder's output: each
    layer's ``enc_out @ wk`` and ``enc_out @ wv`` (no RoPE, no k-norm) at
    the frames' positions, stacked into new leaves (on a mesh, placed as
    the products come out, as the ring-gathered K/V are)."""
    for name, w in (("k", "wk"), ("v", "wv")):
        cross[name] = torch.stack([
            project_heads(enc_out, p_cross[w][i]).to(cross[name].dtype)
            for i in range(cross[name].shape[0])])
    kp = cross["kpos"]
    cross["kpos"] = torch.arange(kp.shape[-1], dtype=kp.dtype, device=kp.device).expand(
        kp.shape).contiguous()


def _sub_blocks(cache, collected):
    """Each sub-block's cache beside what it collected: the looped units'
    (stacked), then the single layers' (leading and remainder)."""
    for grp, col in collected.items():
        if grp == "layers":
            for key, col_b in col.items():
                yield cache["layers"][key], col_b
        else:  # a leading or remainder layer
            yield cache[grp], col


def _fill_cache_from_collected(cache, collected, S):
    for cache_b, col_b in _sub_blocks(cache, collected):
        _fill_unit_cache(cache_b, col_b, S)
    return cache


def _write_delta(sub: dict, delta: dict, pos):
    """Write one sub-block's decode delta (K/V or MLA's latents, one position)
    into its cache slot ``pos % ring``, in place, with the slot as a device
    tensor (no host read): ``attn``'s ring, or ``xattn``'s ``self`` ring.
    The ring axis is the cache's: 2 for the units' stacked leaves, 1 for a
    single layer's.  A placed cache is written shard by shard: each delta
    is first redistributed to its leaf's placements (an explicit
    redistribution: DTensor's in-place ``index_copy_`` may change the
    leaf's placements), then each rank copies into its own shard, whose
    ring axis ``cache_pspecs`` never cuts, so the slot is the same there."""
    tgt = sub["self"] if "self" in sub else sub["attn"]
    kp = tgt["kpos"]
    axis = kp.ndim - 1
    slot = shd.local((pos % kp.shape[axis]).to(torch.int64).reshape(1))
    for name, leaf in delta.items():
        dst = tgt[name]
        shd.local(dst).index_copy_(axis, slot, shd.local(shd.like(leaf.to(dst.dtype), dst)))
    kl = shd.local(kp)
    kl.index_copy_(axis, slot, shd.local(pos).expand(kl.shape[:axis] + (1,)).contiguous())
    return sub


def decode_step(params, cfg, cache, tokens, *, mrope_positions=None):
    """tokens: (B, 1). Returns (logits (B, V), cache).

    The attention layers read the cache and return their K/V deltas;
    each leaf's deltas are then written into the cache's slot in place
    (the cache passed in is the one returned), as the ``ssm`` and ``rec``
    layers write their states and conv windows while they run, and
    ``cache["pos"]`` advances on the device."""
    B = tokens.shape[0]
    pos = cache["pos"]
    positions = pos.expand(B, 1)
    x = _embed_in(params, cfg, tokens, pos)
    mrope_positions = _text_positions(cfg, positions, mrope_positions)
    x, collected, _ = _apply_stack(
        params, cfg, x, positions, mode="decode", cache=cache,
        mrope_positions=mrope_positions, remat=False,
    )
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params, x, cfg.tie_embeddings)[:, 0]
    for cache_b, col_b in _sub_blocks(cache, collected):
        _write_delta(cache_b, col_b["delta"], pos)
    cache["pos"] = pos + 1
    return logits, cache
