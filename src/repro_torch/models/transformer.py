"""Block composition: pre-norm residual blocks, pattern units, the unit loop.

The port of ``repro.models.transformer``.  A model is a stack of units
whose parameters (and decode caches) are stacked on a leading layer axis,
as in the reference; ``scan_units`` walks that axis in a Python loop,
each leaf unbound once (``unstack``).  With ``remat`` and grad enabled
each unit runs under ``torch.utils.checkpoint`` (``remat_call``): its
activations are recomputed in the backward pass, where the reference
wraps its scan body in ``jax.checkpoint(..., nothing_saveable)``; the
values do not change.  Sub-block kinds:
  attn   — GQA/MLA attention + (MLP | MoE), the MoE aux loss summed
  rec    — Griffin recurrent block + MLP
  ssm    — Mamba-2 mixer (no separate MLP)
  xattn  — encoder-decoder block (self + cross attention + MLP)
In decode the ``ssm`` and ``rec`` sub-blocks write their new state and
conv window into the cache in place (``copy_`` into the stacked leaves'
views), where the reference returns them through its cache channel; a
placed cache is written shard by shard, each value first redistributed
to its leaf's placements, as ``model._write_delta`` writes K/V.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import sharding as shd
from ..sharding import constrain
from .attention import gqa_attention, mla_attention
from .layers import layer_norm, mlp, rms_norm
from .moe import moe_ffn
from .rglru import recurrent_block
from .schema import tree_items, tree_map
from .ssm import ssm_block


def norm(p, x, cfg):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.embed_scale:  # gemma stores scale-1
        return rms_norm(x, p["scale"], cfg.norm_eps, offset=1.0)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def layer_kinds(cfg) -> list[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.block_pattern:
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.is_encoder_decoder:
        return ["xattn"] * cfg.n_layers
    return ["attn"] * cfg.n_layers


def unit_pattern(cfg) -> tuple[str, ...]:
    if cfg.family == "ssm":
        return ("ssm",)
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.is_encoder_decoder:
        return ("xattn",)
    return ("attn",)


def split_layers(cfg) -> tuple[int, int, list[str]]:
    """(n_prefix_unscanned, n_scanned_units, tail_kinds)."""
    kinds = layer_kinds(cfg)
    pat = unit_pattern(cfg)
    prefix = cfg.first_dense_layers
    body = cfg.n_layers - prefix
    n_units = body // len(pat)
    tail = kinds[prefix + n_units * len(pat) :]
    return prefix, n_units, tail


# ---------------------------------------------------------------------------
# Sub-block application
# ---------------------------------------------------------------------------


def _state_block(kind, block, p, x, cfg, cache, mode):
    """An ``ssm`` or ``rec`` mixer on the normed input, residual added.  In
    decode its new state and conv window go into ``cache[kind]`` in place
    (on a mesh into each rank's own shard, after a redistribution to the
    leaf's placements, which the cache keeps)."""
    sub = cache.get(kind) if cache else None
    h, c_new, state = block(p[kind], norm(p["norm"], x, cfg), cfg, cache=sub)
    if c_new is not None:
        for name, leaf in c_new.items():
            dst = sub[name]
            shd.local(dst).copy_(shd.local(shd.like(leaf.to(dst.dtype), dst)))
    return x + h, ({kind: state} if mode == "prefill" else None)


def apply_subblock(
    kind: str,
    p: dict,
    x,
    cfg,
    positions,
    *,
    mode: str,  # train | prefill | decode
    cache: Optional[dict] = None,
    enc_out=None,
    mrope_positions=None,
    is_moe_layer: bool = False,
):
    """Returns (x, collected, aux): collected the K/V (or latents, or an
    ``ssm``/``rec`` state and conv window) for prefill, the K/V delta for
    decode; aux the MoE balance loss, 0.0 for a dense MLP."""
    if kind == "ssm":
        x, col = _state_block("ssm", ssm_block, p, x, cfg, cache, mode)
        return x, col, 0.0

    if kind == "rec":
        x, col = _state_block("rec", recurrent_block, p, x, cfg, cache, mode)
        x = x + mlp(p["mlp"], norm(p["mlp_norm"], x, cfg), cfg.mlp_kind)
        return x, col, 0.0

    if kind == "xattn":
        h, kv = gqa_attention(
            p["self_attn"],
            norm(p["norm1"], x, cfg),
            cfg,
            positions,
            causal=True,
            cache=None if cache is None else cache["self"],
            use_rope=cfg.rope in ("rope", "mrope"),
        )
        x = x + h
        h, _ = gqa_attention(
            p["cross_attn"],
            norm(p["norm2"], x, cfg),
            cfg,
            positions,
            causal=False,
            kv_from=enc_out,
            is_cross=True,
            cache=None if cache is None else cache["cross"],
            use_rope=False,
        )
        x = x + h
        x = x + mlp(p["mlp"], norm(p["norm3"], x, cfg), cfg.mlp_kind)
        if mode == "prefill":
            return x, {"self_kv": kv}, 0.0
        if mode == "decode":
            return x, {"delta": kv}, 0.0
        return x, None, 0.0

    sub_cache = cache.get("attn") if cache else None
    if cfg.attn_kind == "mla":
        h, kv = mla_attention(p["attn"], norm(p["norm"], x, cfg), cfg, positions, cache=sub_cache)
    else:
        h, kv = gqa_attention(
            p["attn"],
            norm(p["norm"], x, cfg),
            cfg,
            positions,
            causal=True,
            window=cfg.attn_window,
            cache=sub_cache,
            mrope_positions=mrope_positions,
        )
    x = constrain(x + h, "batch", "seq", "embed")

    aux = 0.0
    if is_moe_layer:
        h2, aux = moe_ffn(p["moe"], norm(p["mlp_norm"], x, cfg), cfg)
    else:
        h2 = mlp(p["mlp"], norm(p["mlp_norm"], x, cfg), cfg.mlp_kind)
    x = constrain(x + h2, "batch", "seq", "embed")

    if mode == "prefill":
        return x, {"kv": kv}, aux
    if mode == "decode" and sub_cache is not None:
        return x, {"delta": kv}, aux
    return x, None, aux


def apply_unit(
    pat: tuple,
    unit_params: dict,
    x,
    cfg,
    positions,
    *,
    mode: str,
    cache=None,
    enc_out=None,
    mrope_positions=None,
    moe_flags: tuple = (),
):
    collected, aux = {}, 0.0
    for i, kind in enumerate(pat):
        key = f"b{i}"
        x, col, a = apply_subblock(
            kind,
            unit_params[key],
            x,
            cfg,
            positions,
            mode=mode,
            cache=None if cache is None else cache[key],
            enc_out=enc_out,
            mrope_positions=mrope_positions,
            is_moe_layer=bool(moe_flags[i]) if moe_flags else cfg.is_moe,
        )
        if col is not None:
            collected[key] = col
        aux = aux + a
    return x, (collected or None), aux


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    grad is enabled: nothing inside is kept for the backward pass, which
    runs ``fn`` again (no randomness inside, so no RNG state is kept)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def unstack(tree, n: int) -> list:
    """The ``n`` slices of a tree of stacked leaves along their leading
    axis.  Each leaf is unbound once, so its backward stacks the slices'
    gradients in one pass; a slice ``t[i]`` a unit would write a zero
    tensor of the whole leaf in each unit's backward."""
    unbound = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda u: u[i], unbound) for i in range(n)]


def _unit_body(pat, p, x, cfg, positions, mode, cache, enc_out, mrope_positions, moe_flags):
    return apply_unit(pat, p, x, cfg, positions, mode=mode, cache=cache, enc_out=enc_out,
                      mrope_positions=mrope_positions, moe_flags=moe_flags)


def scan_units(
    pat,
    stacked_params,
    x,
    cfg,
    positions,
    *,
    mode: str,
    cache=None,
    enc_out=None,
    mrope_positions=None,
    moe_flags=(),
    remat: bool = True,
):
    """The units over the leading axis of ``stacked_params`` (and ``cache``),
    a loop in place of the reference's ``lax.scan``, each unit under
    ``remat_call``.  Returns (x, collected, aux), ``collected`` stacked on
    a leading unit axis, ``aux`` summed."""
    n = next(tree_items(stacked_params))[1].shape[0]
    per_unit, aux = [], 0.0
    for i, unit_params in enumerate(unstack(stacked_params, n)):
        unit_cache = None if cache is None else tree_map(lambda t: t[i], cache)
        x, col, a = remat_call(_unit_body, remat, pat, unit_params, x, cfg, positions,
                               mode, unit_cache, enc_out, mrope_positions, moe_flags)
        per_unit.append(col)
        aux = aux + a
    col = _stack(per_unit) if per_unit and per_unit[0] is not None else None
    return x, col, aux


def _stack(trees: list):
    """Trees of one structure (dicts, tuples, tensors) stacked leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)
