"""Block composition: pre-norm residual blocks, pattern units, the unit loop.

The port of ``repro.models.transformer``.  A model is a stack of units
whose parameters (and decode caches) are stacked on a leading layer axis,
as in the reference; ``scan_units`` walks that axis in a Python loop (no
remat: serving has no backward pass).  This port applies the ``attn``
sub-block: GQA or MLA attention, then a dense MLP or the MoE FFN, whose
load-balance aux loss is summed through the units.  The other kinds are
refused by name until the slice that ports them:
  ssm, rec    — the SSM / RG-LRU / encoder slice
  xattn       — the same slice (the encoder-decoder block)
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import gqa_attention, mla_attention
from .layers import layer_norm, mlp, rms_norm
from .moe import moe_ffn
from .schema import tree_items, tree_map

SSM_SLICE = "the SSM / RG-LRU / encoder slice"


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


def refuse_unported(cfg, kind: str) -> None:
    """Raise ``NotImplementedError`` for a sub-block this port cannot apply
    yet, naming the slice that brings it."""
    if kind in ("ssm", "rec", "xattn"):
        raise NotImplementedError(f"{cfg.name}: '{kind}' blocks come with {SSM_SLICE}")


# ---------------------------------------------------------------------------
# Sub-block application
# ---------------------------------------------------------------------------


def apply_subblock(
    kind: str,
    p: dict,
    x,
    cfg,
    positions,
    *,
    mode: str,  # train | prefill | decode
    cache: Optional[dict] = None,
    mrope_positions=None,
    is_moe_layer: bool = False,
):
    """Returns (x, collected, aux): collected the K/V (or latents) for
    prefill, the delta for decode; aux the MoE balance loss, 0.0 for a
    dense MLP."""
    refuse_unported(cfg, kind)
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
    x = x + h

    aux = 0.0
    if is_moe_layer:
        h2, aux = moe_ffn(p["moe"], norm(p["mlp_norm"], x, cfg), cfg)
    else:
        h2 = mlp(p["mlp"], norm(p["mlp_norm"], x, cfg), cfg.mlp_kind)
    x = x + h2

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
            mrope_positions=mrope_positions,
            is_moe_layer=bool(moe_flags[i]) if moe_flags else cfg.is_moe,
        )
        if col is not None:
            collected[key] = col
        aux = aux + a
    return x, (collected or None), aux


def scan_units(
    pat,
    stacked_params,
    x,
    cfg,
    positions,
    *,
    mode: str,
    cache=None,
    mrope_positions=None,
    moe_flags=(),
):
    """The units over the leading axis of ``stacked_params`` (and ``cache``),
    a loop in place of the reference's ``lax.scan``.  Returns (x, collected,
    aux), ``collected`` stacked on a leading unit axis, ``aux`` summed."""
    n = next(tree_items(stacked_params))[1].shape[0]
    per_unit, aux = [], 0.0
    for i in range(n):
        x, col, a = apply_unit(
            pat,
            tree_map(lambda t: t[i], stacked_params),
            x,
            cfg,
            positions,
            mode=mode,
            cache=None if cache is None else tree_map(lambda t: t[i], cache),
            mrope_positions=mrope_positions,
            moe_flags=moe_flags,
        )
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
