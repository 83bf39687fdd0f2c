"""Incremental (amortized) resize: growth without the stop-the-world pass.

The port of ``repro.filters.incremental_resize``.  ``begin`` freezes the
old structure as its decoded sorted fingerprint stream (a QF is a sorted
multiset, §3) and allocates the wider table empty; every later
``insert`` moves one bounded chunk of the stream across and lands its
fresh keys in a small side-buffer QF, and ``contains`` consults all
three, so no single operation pays more than a chunk.  Requotienting is
monotone, so the stream arrives in the new table's sorted order and the
new planes are built strictly left to right by ``kernels.ops.build_chunk``
(one ``qf_build_span`` launch that scans the chunk with the carried
position and writes its slots in place: O(chunk), never a rebuild).
``finish`` drains what is left in one span append and folds the buffer
in with one sort-free two-stream merge.

Membership is exact at every cursor: entries ``[0, cursor)`` of the
stream answer from the new planes, ``[cursor, n)`` from a binary search
of the stream's suffix, and mid-migration inserts from the buffer.

The JAX package jits the insert step with the state donated, so XLA
updates the partly built planes in place; here the append writes into
the state's planes, and an insert consumes its argument: use the
returned state.  A migrating insert reads nothing on the host.

The in-flight migration is a registered, non-public family: the façade's
``insert``/``contains``/``stats`` dispatch on :class:`MigratingQFConfig`.
``wrap`` re-wraps the drained table into the steady QF, the buffered QF
or the cascade it came from.

I/O accounting: each chunk charges its own sequential read (old layout)
and write (new layout) plus a ``migrate_chunks`` tick in ``IOCounters``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import fuse_filter as fuse
from ..core import quotient_filter as qf
from ..kernels import ops as kops
from . import buffered, cascade, iostats, qf_filter, steady
from .iostats import IOCounters
from .qf_filter import QFilterConfig
from .registry import FilterImpl, by_cfg, register


class MigratingQFConfig(NamedTuple):
    """Static config of an in-flight QF migration (hashable).

    ``wrap`` is the family config (steady / buffered / cascade) the
    drained flat table re-wraps into at :func:`finish`, or None for a
    flat QF.
    ``src_len`` pins the stream length when the source is a fold of
    several structures; 0 means the flat source's slot count."""

    src: QFilterConfig  # old geometry (the frozen stream's split)
    dst: QFilterConfig  # wider geometry being built left to right
    buf: QFilterConfig  # small side buffer absorbing fresh inserts
    chunk: int = 1024  # entries moved per insert batch
    wrap: tuple | None = None  # family cfg to re-wrap into at finish
    src_len: int = 0  # stream length override (0 = src slots)


class MigrationState(NamedTuple):
    """Frozen source stream + partial target + buffer, on one device."""

    src_fq: torch.Tensor  # int64 (src_len,) sorted quotients (src split)
    src_fr: torch.Tensor  # int64 matching remainders
    src_n: torch.Tensor  # int32 scalar: valid prefix of the stream
    cursor: torch.Tensor  # int32 scalar: entries [cursor, src_n) pending
    dst: qf.QFState  # holds exactly the entries [0, cursor)
    last_pos: torch.Tensor  # int32 carry of the append (-1 initially)
    last_fq: torch.Tensor  # int32 carry of the append (-1 initially)
    buf: qf.QFState  # fresh inserts that arrived mid-migration
    io: IOCounters


def _default_buf_q(cfg: QFilterConfig) -> int:
    # 8x smaller than the source table (floor 2**8): fresh inserts at up
    # to chunk/8 keys a batch fit for the whole drain
    return max(8, cfg.q - 3)


def _minus_one(device) -> torch.Tensor:
    return torch.full((), -1, dtype=torch.int32, device=device)


def begin(
    cfg: QFilterConfig,
    state: qf.QFState,
    new_q: int | None = None,
    chunk: int = 1024,
    buf_q: int | None = None,
):
    """Freeze ``(cfg, state)`` and open a migration to ``new_q`` bits.

    One decode pass over the old table: no sort, no rebuild.  Returns
    the opaque ``(MigratingQFConfig, MigrationState)`` pair.
    """
    if new_q is None:
        new_q = cfg.q + 1
    new_r = cfg.q + cfg.r - new_q
    if not (cfg.q < new_q <= 30 and new_r >= 1):
        raise ValueError(
            f"cannot migrate q={cfg.q} to q={new_q} within p={cfg.q + cfg.r}"
        )
    if chunk < 1:
        raise ValueError("chunk must be positive")
    if buf_q is None:
        buf_q = _default_buf_q(cfg)
    dst = cfg._replace(q=new_q, r=new_r)
    buf = cfg._replace(q=buf_q, r=cfg.q + cfg.r - buf_q)
    mcfg = MigratingQFConfig(src=cfg, dst=dst, buf=buf, chunk=chunk)
    dev = state.n.device
    src_fq, src_fr, src_n = qf_filter.extract_fn(cfg.backend)(cfg.core, state)
    io = iostats.zeros(dev)
    io = io._replace(resizes=torch.ones((), dtype=torch.int32, device=dev))
    ms = MigrationState(
        src_fq=src_fq,
        src_fr=src_fr,
        src_n=src_n,
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        dst=qf.empty(dst.core, dev)._replace(overflow=state.overflow),
        last_pos=_minus_one(dev),
        last_fq=_minus_one(dev),
        buf=qf.empty(buf.core, dev),
        io=io,
    )
    return mcfg, ms


def begin_stream(
    src: QFilterConfig,
    fq,
    fr,
    n,
    dst: QFilterConfig,
    *,
    chunk: int = 1024,
    buf_q: int | None = None,
    wrap=None,
    io: IOCounters | None = None,
):
    """Open a migration from an already decoded sorted int64 stream.

    The stream may be the fold of several structures, so its length is
    pinned in the config (``src_len``)."""
    if chunk < 1:
        raise ValueError("chunk must be positive")
    if buf_q is None:
        buf_q = _default_buf_q(dst)
    buf = dst._replace(q=buf_q, r=dst.q + dst.r - buf_q)
    mcfg = MigratingQFConfig(
        src=src, dst=dst, buf=buf, chunk=chunk, wrap=wrap, src_len=int(fq.shape[0])
    )
    dev = fq.device
    base = iostats.zeros(dev) if io is None else io
    ms = MigrationState(
        src_fq=fq,
        src_fr=fr,
        src_n=qf._i32(n, dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        dst=qf.empty(dst.core, dev),
        last_pos=_minus_one(dev),
        last_fq=_minus_one(dev),
        buf=qf.empty(buf.core, dev),
        io=base._replace(resizes=base.resizes + 1),
    )
    return mcfg, ms


def _flat_of(core: qf.QFConfig, template) -> QFilterConfig:
    """A QFilterConfig whose ``.core`` is exactly ``core`` (backend carried
    over from the family config ``template``)."""
    return QFilterConfig(
        q=core.q,
        r=core.r,
        slack=core.slack,
        seed=core.seed,
        max_load=core.max_load,
        backend=template.backend,
    )


def grows_by_migration(cfg) -> bool:
    """Families whose growth step re-streams data, and so take the chunked
    path under ``auto_scale``.  The cascade's ``grow`` appends an empty
    level (free); only its geometry ``resize`` migrates."""
    return isinstance(
        cfg, (QFilterConfig, steady.SteadyQFConfig, buffered.BufferedQFConfig)
    )


def can_migrate(cfg) -> bool:
    """Does this family config have an incremental restructure path?"""
    return isinstance(
        cfg,
        (
            QFilterConfig,
            steady.SteadyQFConfig,
            buffered.BufferedQFConfig,
            cascade.CascadeConfig,
        ),
    )


def begin_restructure(cfg, state, *, chunk: int = 1024, buf_q=None, **target):
    """Open a chunked migration for any family with a restructure path.

    * flat QF: :func:`begin` (``new_q``);
    * steady QF: settle, then migrate the table to ``new_q``; the
      drained table re-wraps as an idle steady state;
    * buffered QF: RAM and disk fold into one disk-split stream that
      migrates to the wider disk geometry (``disk_q``), the disk
      re-stream amortized;
    * cascade: every level (frozen ones from their runs) folds into one
      canonical stream migrating toward the new geometry's fitting level
      (``levels``/``fanout``); a frozen target peels at re-wrap time.

    Returns the opaque ``(MigratingQFConfig, MigrationState)`` pair.
    """
    if isinstance(cfg, QFilterConfig):
        return begin(
            cfg, state, new_q=target.pop("new_q", None), chunk=chunk, buf_q=buf_q
        )
    if isinstance(cfg, steady.SteadyQFConfig):
        state = steady.settle_all(cfg, state)
        new_q = target.pop("new_q", cfg.q + 1)
        new_r = cfg.q + cfg.r - new_q
        wrap = steady._resolve_buf_q(cfg._replace(q=new_q, r=new_r, buf_q=0))
        steady._check_geometry(wrap)
        flat_cfg = cfg.flat
        fq, fr, n = qf_filter.extract_fn(flat_cfg.backend)(flat_cfg.core, state.table)
        return begin_stream(
            flat_cfg,
            fq,
            fr,
            n,
            _flat_of(flat_cfg.core._replace(q=new_q, r=new_r), cfg),
            chunk=chunk,
            buf_q=buf_q,
            wrap=wrap,
            io=state.io,
        )
    if isinstance(cfg, buffered.BufferedQFConfig):
        disk_q = target.pop("disk_q", cfg.disk_q + 1)
        wrap = cfg._replace(disk_q=disk_q)
        if not (wrap.ram_q < disk_q < wrap.p):
            raise ValueError(
                f"disk_q={disk_q} must lie strictly between ram_q={cfg.ram_q} "
                f"and p={cfg.p}"
            )
        extract = qf_filter.extract_fn(cfg.backend)
        dq, dr, dn = extract(cfg.disk, state.disk)
        rq, rr, rn = extract(cfg.ram, state.ram)
        rq, rr = qf._requotient(rq, rr, cfg.ram, cfg.disk)
        fq, fr, n = qf.merge_streams_many([(dq, dr, dn), (rq, rr, rn)])
        dev = fq.device
        io = state.io._replace(
            seq_read_bytes=state.io.seq_read_bytes
            + iostats.f32(cfg.disk.size_bytes, dev)
        )
        return begin_stream(
            _flat_of(cfg.disk, cfg),
            fq,
            fr,
            n,
            _flat_of(wrap.disk, cfg),
            chunk=chunk,
            buf_q=buf_q,
            wrap=wrap,
            io=io,
        )
    if isinstance(cfg, cascade.CascadeConfig):
        wrap = cfg._replace(
            levels=target.pop("levels", cfg.levels),
            fanout=target.pop("fanout", cfg.fanout),
        )
        cascade._check_geometry(wrap)
        parts, read, overflow = cascade._all_streams(cfg, state)
        fq, fr, n = qf.merge_streams_many(parts)
        dev = fq.device
        tgt = _cascade_target(wrap, int(n))
        io = state.io._replace(
            seq_read_bytes=state.io.seq_read_bytes + iostats.f32(read, dev)
        )
        mcfg, ms = begin_stream(
            _flat_of(cascade._canon_cfg(cfg), cfg),
            fq,
            fr,
            n,
            _flat_of(wrap.level_cfg(tgt), cfg),
            chunk=chunk,
            buf_q=buf_q,
            wrap=wrap,
            io=io,
        )
        if overflow:
            true = torch.ones((), dtype=torch.bool, device=dev)
            ms = ms._replace(dst=ms.dst._replace(overflow=true))
        return mcfg, ms
    raise TypeError(f"{type(cfg).__name__} has no incremental restructure path")


def _cascade_target(wrap, total: int) -> int:
    """Smallest level of the new geometry that fits the union count."""
    return cascade._fitting_level(wrap, total)


def _rewrap(mcfg: MigratingQFConfig, state: qf.QFState, io: IOCounters):
    """Re-wrap the drained flat table as the target family's state."""
    wrap = mcfg.wrap
    dev = state.n.device
    if isinstance(wrap, steady.SteadyQFConfig):
        return wrap, steady.from_flat(wrap, state, io=io)
    if isinstance(wrap, buffered.BufferedQFConfig):
        io = io._replace(
            seq_write_bytes=io.seq_write_bytes + iostats.f32(wrap.disk.size_bytes, dev)
        )
        return wrap, buffered.BufferedQFState(
            ram=qf.empty(wrap.ram, dev), disk=state, io=io
        )
    if isinstance(wrap, cascade.CascadeConfig):
        tgt = _cascade_target(wrap, int(state.n))
        io = io._replace(
            seq_write_bytes=io.seq_write_bytes
            + iostats.f32(cascade._level_write_bytes(wrap, tgt), dev),
            merges=io.merges + 1,
        )
        if wrap.is_frozen(tgt):
            fq, fr, n = qf_filter.extract_fn(mcfg.dst.backend)(mcfg.dst.core, state)
            fq, fr = qf._requotient(fq, fr, mcfg.dst.core, cascade._canon_cfg(wrap))
            merged = fuse_freeze(wrap, tgt, fq, fr, n, state.overflow)
        elif wrap.level_cfg(tgt) != mcfg.dst.core:
            # the buffer's keys pushed the count past the level the table
            # was built for: re-stream it into the level that fits.  (The
            # JAX package places the table there as it is, with the planes
            # of another level's geometry; see ROADMAP.md, Queue 3.)
            merged = qf.multi_merge(
                wrap.level_cfg(tgt), [(mcfg.dst.core, state)],
                build=qf_filter.build_fn(mcfg.dst.backend),
                extract=qf_filter.extract_fn(mcfg.dst.backend),
            )
        else:
            merged = state
        levels = cascade._empty_levels(wrap, dev, {tgt: merged})
        return wrap, cascade.CascadeState(
            q0=qf.empty(wrap.q0_cfg, dev), levels=levels, io=io
        )
    raise TypeError(f"cannot re-wrap migration into {type(wrap).__name__}")


def fuse_freeze(wrap, i: int, fq, fr, n, overflow):
    """Peel a canonical stream into frozen level ``i`` of cascade config
    ``wrap``: the one step of a migration that cannot be chunked."""
    st = fuse.freeze_stream(wrap.fuse_cfg(i), fq, fr, n)
    return st._replace(overflow=st.overflow | overflow)


def blank(mcfg: MigratingQFConfig, device=None) -> MigrationState:
    """An all-zero state with this config's shapes (a restore's template)."""
    dev = qf.resolve_device(device)
    t = mcfg.src_len or mcfg.src.core.total_slots
    return MigrationState(
        src_fq=torch.full((t,), qf.INT32_MAX, dtype=torch.int64, device=dev),
        src_fr=torch.full((t,), qf.UINT32_MAX, dtype=torch.int64, device=dev),
        src_n=torch.zeros((), dtype=torch.int32, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        dst=qf.empty(mcfg.dst.core, dev),
        last_pos=_minus_one(dev),
        last_fq=_minus_one(dev),
        buf=qf.empty(mcfg.buf.core, dev),
        io=iostats.zeros(dev),
    )


def is_migrating(cfg) -> bool:
    return isinstance(cfg, MigratingQFConfig)


def _advance(mcfg: MigratingQFConfig, ms: MigrationState, steps: int = 1):
    """Move up to ``steps * chunk`` pending entries into the new planes.

    Device arithmetic with static shapes and no host read: a masked
    no-op once the stream is drained.  The carried probe scan closes
    over any span length, so a multi-step advance is one span append,
    bit for bit the ``steps`` chunk moves (the JAX package's chunk
    scatter and span kernel are one ``qf_build_span`` launch here); the
    I/O ledger still charges one ``migrate_chunks`` tick per chunk-sized
    slice moved.  Consumes ``ms.dst``'s planes (the append writes them
    in place).
    """
    src, dst = mcfg.src.core, mcfg.dst.core
    C = mcfg.chunk
    dev = ms.src_fq.device
    idx = ms.cursor + torch.arange(C * steps, dtype=torch.int32, device=dev)
    valid = idx < ms.src_n
    gi = idx.clamp(0, ms.src_fq.shape[0] - 1).to(torch.int64)
    fq = torch.where(valid, ms.src_fq[gi], qf.INT32_MAX)
    fr = torch.where(valid, ms.src_fr[gi], qf.UINT32_MAX)
    fq, fr = qf._requotient(fq, fr, src, dst)
    moved = valid.sum(dtype=torch.int32)
    new_dst, last_pos, last_fq = kops.build_span(
        dst, ms.dst, fq, fr, moved, ms.last_pos, ms.last_fq
    )
    moved_f = moved.to(torch.float32)
    io = ms.io._replace(
        seq_read_bytes=ms.io.seq_read_bytes + moved_f * (src.bits_per_slot / 8.0),
        seq_write_bytes=ms.io.seq_write_bytes + moved_f * (dst.bits_per_slot / 8.0),
        migrate_chunks=ms.io.migrate_chunks + (moved + C - 1) // C,
    )
    return ms._replace(
        cursor=ms.cursor + moved,
        dst=new_dst,
        last_pos=last_pos,
        last_fq=last_fq,
        io=io,
    )


def insert(mcfg: MigratingQFConfig, ms: MigrationState, keys, k=None):
    """Migrate one chunk, then land the fresh keys in the side buffer.

    The per-batch cost is the chunk move plus a small-buffer insert,
    never a full-table pass, and no host read.  The chunk is appended
    into ``ms.dst``'s planes in place: use the returned state, not the
    argument.  A batch over the buffer's slack sets its ``overflow``
    flag; ``auto_scale`` settles the migration before such a batch.
    """
    ms = _advance(mcfg, ms)
    buf = qf_filter.insert_keys(mcfg.buf.core, mcfg.buf.backend, ms.buf, keys, k)
    return ms._replace(buf=buf)


def _suffix_hit(ms: MigrationState, fq, fr):
    """Does the not-yet-migrated stream suffix hold this fingerprint?"""
    lo = qf.lex_searchsorted(ms.src_fq, ms.src_fr, fq, fr, "left")
    hi = qf.lex_searchsorted(ms.src_fq, ms.src_fr, fq, fr, "right")
    return hi > torch.maximum(lo, ms.cursor)


def contains(mcfg: MigratingQFConfig, ms: MigrationState, keys):
    """MAY-CONTAIN across the three slices, exact at every cursor: the
    migrated prefix answers from the new planes, the pending suffix from
    the stream, fresh keys from the buffer."""
    src = mcfg.src
    fq_s, fr_s = qf_filter.fingerprint_fn(src.backend)(src.core, keys)
    hit = _suffix_hit(ms, fq_s, fr_s)
    hit = hit | qf_filter.contains_keys(
        mcfg.dst.core, mcfg.dst.backend, ms.dst, keys, mcfg.dst.window
    )
    return hit | qf_filter.contains_keys(
        mcfg.buf.core, mcfg.buf.backend, ms.buf, keys, mcfg.buf.window
    )


def migration_done(mcfg: MigratingQFConfig, ms: MigrationState):
    """Bool scalar: the frozen stream is fully drained."""
    return ms.cursor >= ms.src_n


def needs_settle(mcfg: MigratingQFConfig, ms: MigrationState):
    """Bool scalar: call :func:`finish` now, because the stream is drained
    or the side buffer nears its own capacity."""
    buf_full = ms.buf.n >= mcfg.buf.core.capacity
    return migration_done(mcfg, ms) | buf_full


def finish(mcfg: MigratingQFConfig, ms: MigrationState):
    """Collapse the migration into a plain ``(cfg, state)`` pair.

    Drains any pending entries in one span append, then folds the side
    buffer in with one sort-free two-stream merge and one build.
    """
    pending = int(ms.src_n - ms.cursor)
    if pending > 0:
        ms = _advance(mcfg, ms, steps=-(-pending // mcfg.chunk))
    dst_core = mcfg.dst.core
    if int(ms.buf.n) == 0:
        state = ms.dst
    else:
        dq, dr, dn = qf_filter.extract_fn(mcfg.dst.backend)(dst_core, ms.dst)
        bq, br, bn = qf_filter.extract_fn(mcfg.buf.backend)(mcfg.buf.core, ms.buf)
        bq, br = qf._requotient(bq, br, mcfg.buf.core, dst_core)
        allq, allr = qf.merge_streams(dq, dr, dn, bq, br, bn)
        build = qf_filter.build_fn(mcfg.dst.backend)
        state = build(dst_core, allq, allr, dn + bn)
        state = state._replace(
            overflow=state.overflow | ms.dst.overflow | ms.buf.overflow
        )
    if mcfg.wrap is not None:
        return _rewrap(mcfg, state, ms.io)
    return mcfg.dst, state


# -- registry bindings (non-public: constructed by begin(), not by name) ----


def _make(device=None, **spec):
    """Open a migration directly from a flat-QF spec."""
    new_q = spec.pop("new_q", None)
    chunk = spec.pop("chunk", 1024)
    buf_q = spec.pop("buf_q", None)
    cfg, state = qf_filter.make(device=device, **spec)
    return begin(cfg, state, new_q=new_q, chunk=chunk, buf_q=buf_q)


def _grow(mcfg: MigratingQFConfig, ms: MigrationState):
    """Settle, then take the (re-wrapped) family's doubling step."""
    cfg, state = finish(mcfg, ms)
    return by_cfg(cfg).grow(cfg, state)


def _resize(mcfg: MigratingQFConfig, ms: MigrationState, **kw):
    cfg, state = finish(mcfg, ms)
    return by_cfg(cfg).resize(cfg, state, **kw)


def stats(mcfg: MigratingQFConfig, ms: MigrationState):
    pending = ms.src_n - ms.cursor
    return {
        "n": pending + ms.dst.n + ms.buf.n,
        "migrating": torch.ones((), dtype=torch.bool, device=ms.cursor.device),
        "cursor": ms.cursor,
        "pending": pending,
        "buffered": ms.buf.n,
        "load": (ms.dst.n + ms.buf.n + pending).to(torch.float32) / mcfg.dst.core.m,
        "overflow": ms.dst.overflow | ms.buf.overflow,
        "size_bytes": mcfg.src.core.size_bytes
        + mcfg.dst.core.size_bytes
        + mcfg.buf.core.size_bytes,
        **ms.io._asdict(),
    }


IMPL = register(
    FilterImpl(
        name="migrating_qf",
        paper_section="§3 resizing, amortized (the incremental variant)",
        cfg_cls=MigratingQFConfig,
        make=_make,
        insert=insert,
        contains=contains,
        stats=stats,
        needs_resize=needs_settle,
        grow=_grow,
        resize=_resize,
    ),
    public=False,
)
