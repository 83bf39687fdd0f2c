"""``repro_torch.filters`` — the functional AMQ API of ``repro.filters``, in PyTorch.

Registry name -> implementation -> paper section:

========================  =======================================================
``"qf"``                  Quotient filter (§3): insert, may-contain, delete, merge.
``"bloom"``               Bloom filter baseline (§2); ``counting=True`` gives the
                          counting variant [3] with delete + additive merge.
``"blocked_bloom"``       Hash-localized Bloom filter (§2, buffered BF of Canim
                          et al.): all k probes in one block/page.
``"buffered_qf"``         Buffered quotient filter (§4): RAM QF buffer flushed
                          into a large flash QF by one streaming merge.
``"cascade"``             Cascade filter (§4): COLA-style geometric hierarchy of
                          QFs; ``frozen_below=k`` demotes levels >= k to
                          binary-fuse tables (no delete).
``"xor_fuse"``            Frozen binary-fuse filter (§4 cold levels, beyond the
                          paper): construct-only; merge/extend/grow/shrink
                          re-peel, insert/delete raise.
``"sharded_qf"``          Multi-device QF (§6 future work): quotient-prefix
                          sharding, each shard's keys routed to it by one
                          exchange each way; shards on a list of devices.
``"steady_qf"``           Steady-state QF (§4 RAM buffer kept always-on): every
                          insert lands in a small buffer QF and moves one
                          bounded settle chunk into the table.
========================  =======================================================

Every family resizes (the paper's §3 "dynamic resizing"): ``grow``,
``resize``, ``shrink`` and the ``needs_resize``/``needs_shrink``
predicates.  :func:`auto_grow` composes them with ``insert`` by the
blocking ``grow``; :func:`auto_scale` grows a ``qf``, ``buffered_qf``
or ``steady_qf`` incrementally instead (``filters.incremental_resize``:
each batch moves one bounded chunk into the wider table), grows the
others by the blocking ``grow``, and shrinks on a low watermark.

Quickstart::

    from repro_torch import filters

    cfg, state = filters.make("qf", q=16, r=12)      # state on the card
    state = filters.insert(cfg, state, keys)
    hits = filters.contains(cfg, state, keys)        # bool[B], no false negatives
    state = filters.delete(cfg, state, keys[:100])

The spec dictionaries are those of ``repro.filters``.  ``make`` puts the
state on the CUDA device unless it is given ``device="cpu"``, and raises
without a card; ``sharded_qf`` takes one device for one shard or a list
of ``n_shards`` devices, which may repeat (``filters.sharded``).
``backend="pallas"`` runs the port's CUDA kernels on card state.
:func:`from_numpy` and :func:`to_numpy` carry a state
across from the JAX package and back as its pytree leaves: ``rem``
planes and fuse tables as uint32, counting Bloom cells (int16 here) as
uint16, and the int64 streams (a frozen level's run, a migration's
source stream, the steady family's ``src``/``bsrc``/``out`` settle
streams) as int32 quotients and uint32 remainders; a ``sharded_qf``
state as the JAX package's stacked per-shard leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core import quotient_filter as qf
from . import (  # noqa: F401 (registration)
    auto_scale as _auto_scale,
    bloom_filter,
    buffered,
    cascade,
    incremental_resize,
    iostats,
    qf_filter,
    sharded,
    steady,
    xor_fuse,
)
from .auto_scale import settle
from .iostats import IOCounters, to_iolog
from .registry import FilterImpl, UnsupportedOpError, by_cfg, by_name, names, register

# every op name ``supports`` answers for, as in ``repro.filters``
_OPS = frozenset(
    {
        "insert",
        "contains",
        "delete",
        "merge",
        "probe",
        "stats",
        "needs_resize",
        "grow",
        "resize",
        "needs_shrink",
        "shrink",
    }
)


def _leaves(state, name=""):
    """``(field name, tensor)`` pairs in the JAX pytree's leaf order."""
    if isinstance(state, torch.Tensor):
        yield name, state
    elif hasattr(state, "_fields"):
        for field, value in zip(state._fields, state):
            yield from _leaves(value, field)
    else:
        for value in state:
            yield from _leaves(value, name)


def _device(state) -> torch.device:
    return next(_leaves(state))[1].device


def _keys(state, keys) -> torch.Tensor:
    """Keys as a tensor on the state's device (numpy arrays are copied there)."""
    return torch.as_tensor(keys, device=_device(state))


def make(name: str, device=None, **spec):
    """Construct a filter by registry name: ``make(name, **spec) -> (cfg, state)``."""
    return by_name(name).make(device=device, **spec)


def insert(cfg, state, keys, k=None):
    """Insert a key batch; ``k`` = optional valid-prefix count for padded batches."""
    with tracing.span("filters.insert"):
        return by_cfg(cfg).require("insert")(cfg, state, _keys(state, keys), k)


def contains(cfg, state, keys):
    """MAY-CONTAIN for a key batch (no false negatives)."""
    with tracing.span("filters.contains"):
        return by_cfg(cfg).contains(cfg, state, _keys(state, keys))


def delete(cfg, state, keys, k=None):
    """Remove one copy of each key (check ``supports(cfg, "delete")``)."""
    return by_cfg(cfg).require("delete", cfg)(cfg, state, _keys(state, keys), k)


def merge(cfg, state_a, state_b):
    """Union two same-config filters into one state."""
    return by_cfg(cfg).require("merge")(cfg, state_a, state_b)


def probe(cfg, state, keys):
    """``contains`` + modeled I/O accounting: returns ``(state, hits)``."""
    impl = by_cfg(cfg)
    keys = _keys(state, keys)
    if impl.probe is None:
        return state, impl.contains(cfg, state, keys)
    return impl.probe(cfg, state, keys)


def stats(cfg, state) -> dict:
    """Scalar diagnostics (count, load, overflow, I/O counters...)."""
    return by_cfg(cfg).stats(cfg, state)


def needs_resize(cfg, state):
    """Is the filter at or over its design capacity?  A bool scalar tensor.

    Filters without a resize binding report a constant False.
    """
    impl = by_cfg(cfg)
    if impl.needs_resize is None:
        return torch.zeros((), dtype=torch.bool, device=_device(state))
    return impl.needs_resize(cfg, state)


def needs_shrink(cfg, state):
    """Is the filter far enough under its low watermark to halve?  A bool scalar.

    Filters without a shrink binding report a constant False.
    """
    impl = by_cfg(cfg)
    if impl.needs_shrink is None:
        return torch.zeros((), dtype=torch.bool, device=_device(state))
    return impl.needs_shrink(cfg, state)


def grow(cfg, state):
    """One doubling step (:class:`UnsupportedOpError` for a family without one)."""
    return by_cfg(cfg).require("grow")(cfg, state)


def resize(cfg, state, **kw):
    """Structural resize (:class:`UnsupportedOpError` for a family without one)."""
    return by_cfg(cfg).require("resize")(cfg, state, **kw)


def shrink(cfg, state):
    """One halving step (:class:`UnsupportedOpError` for a family without one)."""
    return by_cfg(cfg).require("shrink")(cfg, state)


def auto_grow(cfg, state, keys, k=None, max_steps: int = 32):
    """Insert with automatic growth: the dynamic-resizing ingest driver.

    Applies ``grow`` steps before and after the insert until
    ``needs_resize`` clears, so an unbounded stream goes through a filter
    that started at any size.  Returns the new ``(cfg, state)`` pair.
    Each predicate is one host read: a driver for host-driven loops.
    """
    impl = by_cfg(cfg)
    can = impl.needs_resize is not None and impl.grow is not None
    keys = _keys(state, keys)

    def settle_up(cfg, state):
        for _ in range(max_steps):
            if not bool(impl.needs_resize(cfg, state)):
                return cfg, state
            cfg, state = impl.grow(cfg, state)
        raise RuntimeError(
            f"{impl.name}: still over capacity after {max_steps} grow steps"
        )

    if can:
        cfg, state = settle_up(cfg, state)
    state = impl.require("insert")(cfg, state, keys, k)
    if can:
        cfg, state = settle_up(cfg, state)
    return cfg, state


def auto_scale(cfg, state, keys, k=None, **kw):
    """Insert with watermark-driven growth (incremental where the family
    can) and shrinkage; see :mod:`repro_torch.filters.auto_scale`.
    Returns the new ``(cfg, state)`` pair, mid-migration the migrating
    wrapper's."""
    return _auto_scale.auto_scale(cfg, state, _keys(state, keys), k, **kw)


def supports(name_or_cfg, op: str) -> bool:
    """Does filter ``name_or_cfg`` implement op ``op``?  Unknown op names raise."""
    if op not in _OPS:
        raise ValueError(
            f"unknown filter op {op!r}; known ops: {', '.join(sorted(_OPS))}"
        )
    if isinstance(name_or_cfg, str):
        return getattr(by_name(name_or_cfg), op) is not None
    impl = by_cfg(name_or_cfg)
    if op == "delete":
        return impl.deletable(name_or_cfg)
    return getattr(impl, op) is not None


# the JAX package's dtype of each leaf the port holds in another one
_JAX_DTYPES = {
    ("rem", "int32"): "uint32",  # QF remainders, as bit patterns
    ("table", "int32"): "uint32",  # fuse cells, as bit patterns
    ("run_q", "int64"): "int32",  # a frozen level's run, held as int64
    ("run_r", "int64"): "uint32",
    ("src_fq", "int64"): "int32",  # a migration's or a settle's source stream
    ("src_fr", "int64"): "uint32",
    ("bsrc_fq", "int64"): "int32",  # a settle's buffer-side stream
    ("bsrc_fr", "int64"): "uint32",
    ("out_fq", "int64"): "int32",  # a settle's merged output stream
    ("out_fr", "int64"): "uint32",
}


def _jax_dtype(name: str, dtype: np.dtype) -> np.dtype:
    """The dtype of the JAX package's leaf that the port holds in ``dtype``.

    The port keeps unsigned leaves as signed bit patterns (``rem`` planes
    and fuse tables as int32, counting Bloom cells as int16) and the
    fingerprint streams (a frozen level's run, a migration's source
    stream, a settle's three streams) in its int64 stream convention.
    """
    if dtype == np.int16:
        return np.dtype(np.uint16)
    return np.dtype(_JAX_DTYPES.get((name, np.dtype(dtype).name), dtype))


def _cast(a: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """A bit-pattern view where the widths match, a value cast where they do not."""
    if a.dtype.itemsize == np.dtype(dtype).itemsize:
        return a.view(dtype)
    return a.astype(dtype)


def to_numpy(cfg, state) -> list:
    """The state as the JAX package's pytree leaves, as numpy arrays.

    ``rem`` planes and fuse tables come back as uint32, counting Bloom
    cells as uint16, frozen runs, migration and settle streams as
    int32/uint32, every other leaf in its dtype; ``jax.tree_util.tree_unflatten`` of the JAX state's
    treedef over this list rebuilds the JAX state.
    """
    by_cfg(cfg)  # a registered config
    if isinstance(cfg, sharded.ShardedQFilterConfig):
        state = sharded.stacked(state)
    out = []
    for name, t in _leaves(state):
        # a copy: a migration's insert writes the state's planes in place
        a = t.detach().to("cpu", copy=True).numpy()
        out.append(_cast(a, _jax_dtype(name, a.dtype)))
    return out


def from_numpy(cfg, leaves, device=None):
    """A port state from the JAX package's pytree leaves (numpy arrays).

    The inverse of :func:`to_numpy`: each leaf must have the dtype and
    shape of the matching field of ``make``'s state for ``cfg`` (``rem``
    and fuse tables as uint32, counting Bloom cells as uint16, frozen
    runs and fingerprint streams as int32/uint32).  ``device`` is
    ``make``'s argument: a ``sharded_qf`` state's stacked leaves are split
    onto its shards' devices.
    """
    if isinstance(cfg, sharded.ShardedQFilterConfig):
        devices = sharded.shard_devices(cfg.n_shards, device)
        _, blank = sharded.make(device=["meta"] * cfg.n_shards, **cfg._asdict())
        state = _from_leaves(sharded.stacked(blank, "meta"), leaves, "cpu")
        return sharded.unstacked(state, devices)
    device = qf.resolve_device(device)
    if incremental_resize.is_migrating(cfg):
        template = incremental_resize.blank(cfg, device="meta")
    else:
        _, template = by_cfg(cfg).make(device="meta", **cfg._asdict())  # no memory
    return _from_leaves(template, leaves, device)


def _from_leaves(template, leaves, device):
    """``template``'s structure with each tensor read from the leaf in its place."""
    fields = list(_leaves(template))
    leaves = list(leaves)
    if len(leaves) != len(fields):
        raise ValueError(f"expected {len(fields)} leaves, got {len(leaves)}")
    tensors = []
    for (name, like), a in zip(fields, leaves):
        a = np.array(a, order="C")  # a private, writable copy
        held = torch.empty(0, dtype=like.dtype).numpy().dtype
        wire = _jax_dtype(name, held)
        if wire != held:
            if a.dtype != wire:
                raise TypeError(f"{name} leaf must be {wire}, got {a.dtype}")
            a = _cast(a, held)
        t = torch.from_numpy(a)
        if t.dtype != like.dtype or t.shape != like.shape:
            raise ValueError(
                f"{name} leaf is {a.dtype}{tuple(a.shape)}, "
                f"expected {like.dtype}{tuple(like.shape)}"
            )
        tensors.append(t.to(device))
    it = iter(tensors)

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if hasattr(node, "_fields"):
            return type(node)(*(rebuild(v) for v in node))
        return tuple(rebuild(v) for v in node)

    return rebuild(template)


__all__ = [
    "FilterImpl",
    "IOCounters",
    "UnsupportedOpError",
    "auto_grow",
    "auto_scale",
    "by_cfg",
    "by_name",
    "contains",
    "delete",
    "from_numpy",
    "grow",
    "incremental_resize",
    "insert",
    "iostats",
    "make",
    "merge",
    "names",
    "needs_resize",
    "needs_shrink",
    "probe",
    "register",
    "resize",
    "settle",
    "shrink",
    "stats",
    "steady",
    "supports",
    "to_iolog",
    "to_numpy",
]
