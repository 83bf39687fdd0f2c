"""Schema-driven parameters: one source of truth for shapes and initializers.

The port of ``repro.models.schema``.  ``schema(cfg)`` (in model.py)
returns nested dicts of :class:`Param` leaves; from it come random init
(:func:`init_params`, from a ``torch.Generator`` on the target device)
and abstract parameters on the ``meta`` device (:func:`abstract_params`,
no memory).  Leaf shapes, dtypes and the ``zeros``/``ones``/``const``
values equal the JAX package's; random draws do not (a ``torch.Generator``
is not a ``jax.random`` key).  ``param_specs``/``param_pspecs`` map each
leaf's logical axes and shape through the sharding rules.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Param(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis names (same rank as shape)
    init: str = "fan_in"  # fan_in | normal | zeros | ones | const
    scale: Optional[float] = None
    dtype: Optional[str] = None  # override cfg.param_dtype


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts (a ``Param`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_items(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs of nested dicts, keys sorted as
    ``jax.tree_util`` flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of nested dicts, tuples and NamedTuples in
    ``jax.tree_util``'s order: dict keys sorted, tuple fields in order,
    ``None`` no leaf.  ``is_leaf`` stops the walk at a node (a partition
    spec, itself a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure (dict key order kept) holding ``leaves``, given
    in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple):
            parts = [build(x) for x in t]
            return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def _leaf_dtype(p: Param, default: str) -> torch.dtype:
    return getattr(torch, p.dtype or default)


def init_params(schema, generator: torch.Generator, default_dtype: str):
    """Random parameters on ``generator``'s device, drawn from it leaf by leaf."""
    device = generator.device

    def mk(p: Param):
        dt = _leaf_dtype(p, default_dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        if p.init == "const":
            return torch.full(p.shape, p.scale, dtype=dt, device=device)
        if p.init == "normal":
            s = p.scale or 0.02
        else:  # fan_in: normal with 1/sqrt(shape[0]), as the reference
            fan_in = p.shape[0] if len(p.shape) >= 1 else 1
            s = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        z = torch.randn(p.shape, generator=generator, device=device)
        return z.mul_(s).to(dt)

    return tree_map(mk, schema)


def abstract_params(schema, default_dtype: str):
    """Parameters of the schema's shapes and dtypes on the ``meta`` device."""
    return tree_map(
        lambda p: torch.empty(p.shape, dtype=_leaf_dtype(p, default_dtype), device="meta"),
        schema,
    )


def param_specs(schema, rules):
    """(mesh, spec) for every parameter (shape-aware fallback)."""
    return tree_map(lambda p: rules.sharding(p.axes, p.shape), schema)


def param_pspecs(schema, rules):
    """The partition spec (a tuple) of every parameter."""
    return tree_map(lambda p: rules.spec(p.axes, p.shape), schema)
