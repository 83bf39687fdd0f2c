"""``auto_scale``: the watermark-driven ingest and serving driver.

The port of ``repro.filters.auto_scale``.  ``auto_grow`` only ratchets
capacity up, with the blocking one-pass ``grow``; this driver

* grows incrementally where the family can: when the high watermark
  (``needs_resize``) trips on a flat or buffered QF, it opens an
  :mod:`incremental_resize` migration instead of re-streaming the whole
  table under one insert, and collapses it (re-wrapping into the
  original family) once its predicate reports drained.  The cascade's
  ``grow`` appends an empty level (free) and keeps the direct loop;
  families without an incremental path keep the blocking ``grow``;
* shrinks on the low watermark: ``needs_shrink`` fires only when the
  population fits the shrunk structure at ``shrink_load`` of its
  capacity, so a filter oscillating around a boundary never thrashes.

Each predicate is one host read, as in the reference: this is the
host-driven ingest cadence.  ``keys`` are tensors on the state's device
(the façade's ``auto_scale`` moves them there).
"""

from __future__ import annotations

from . import incremental_resize
from .registry import by_cfg


def _settle_up(impl, cfg, state, max_steps: int):
    for _ in range(max_steps):
        if not bool(impl.needs_resize(cfg, state)):
            return cfg, state
        cfg, state = impl.grow(cfg, state)
    raise RuntimeError(
        f"{impl.name}: still over capacity after {max_steps} grow steps"
    )


def _settle_down(impl, cfg, state, max_steps: int):
    for _ in range(max_steps):
        if not bool(impl.needs_shrink(cfg, state)):
            return cfg, state
        cfg, state = impl.shrink(cfg, state)
    return cfg, state


def auto_scale(
    cfg,
    state,
    keys,
    k=None,
    *,
    incremental: bool = True,
    chunk: int = 1024,
    buf_q: int | None = None,
    shrink: bool = True,
    max_steps: int = 32,
):
    """Insert with watermark-driven growth and shrinkage.

    Returns the new ``(cfg, state)`` pair; mid-migration the pair is the
    opaque migrating wrapper, which still answers ``insert``/
    ``contains``/``stats`` through the façade.
    """
    kw = dict(
        incremental=incremental,
        chunk=chunk,
        buf_q=buf_q,
        shrink=shrink,
        max_steps=max_steps,
    )
    if incremental_resize.is_migrating(cfg):
        impl = by_cfg(cfg)
        # a batch the side buffer cannot absorb would overflow inside the
        # insert: collapse the migration first and take the plain path
        kb = int(keys.shape[0] if k is None else k)
        if kb + int(state.buf.n) > cfg.buf.core.capacity:
            cfg, state = incremental_resize.finish(cfg, state)
            return auto_scale(cfg, state, keys, k, **kw)
        state = impl.require("insert")(cfg, state, keys, k)
        if bool(incremental_resize.needs_settle(cfg, state)):
            cfg, state = incremental_resize.finish(cfg, state)
        return cfg, state

    impl = by_cfg(cfg)
    can_up = impl.needs_resize is not None and impl.grow is not None
    use_incremental = incremental and incremental_resize.grows_by_migration(cfg)

    if can_up and bool(impl.needs_resize(cfg, state)):
        if use_incremental:
            cfg, state = incremental_resize.begin_restructure(
                cfg, state, chunk=chunk, buf_q=buf_q
            )
            return auto_scale(cfg, state, keys, k, **kw)
        cfg, state = _settle_up(impl, cfg, state, max_steps)

    state = impl.require("insert")(cfg, state, keys, k)

    if can_up and bool(impl.needs_resize(cfg, state)):
        if use_incremental:
            return incremental_resize.begin_restructure(
                cfg, state, chunk=chunk, buf_q=buf_q
            )
        cfg, state = _settle_up(impl, cfg, state, max_steps)
    elif (
        shrink
        and impl.needs_shrink is not None
        and impl.shrink is not None
        and bool(impl.needs_shrink(cfg, state))
    ):
        cfg, state = _settle_down(impl, cfg, state, max_steps)
    return cfg, state


def settle(cfg, state):
    """Collapse an in-flight migration, if any (host-level, blocking).

    Call before an operation the migrating wrapper lacks (``delete``,
    ``merge``) or before serializing a long-lived filter."""
    if incremental_resize.is_migrating(cfg):
        return incremental_resize.finish(cfg, state)
    return cfg, state
