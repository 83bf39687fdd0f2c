"""Cascade filter, functional (paper §4's insert-optimized on-flash AMQ).

The port of ``repro.filters.cascade``.  COLA-style hierarchy: a RAM
quotient filter Q0 plus a fixed-depth stack of on-"disk" QFs whose
capacities grow geometrically with the fanout.  When Q0 fills, Q0..Qi
are merged into a fresh Qi in one streaming pass, where i is the
smallest level that fits them all (the paper's collapse rule), and the
modeled I/O of that pass is counted in ``IOCounters``.

**Frozen cold tier** (``frozen_below=k``): levels at depth >= k are
binary-fuse tables (``core.fuse_filter``), smaller than the QF at the
same fp-rate target, with a fixed 3-read probe.  A merge-down into a
frozen level peels the merged stream into its table; a later merge that
consumes the level re-expands it from its retained sorted run.  Deletes
are refused: a fuse table cannot unlink a key.

The JAX package picks the collapse (and the ``merge`` target) with a
``lax.switch`` on device counts; here the branch is chosen on one host
read per insert batch, and a frozen target's peel reads the host a few
times more (``fuse_filter.peel_counts``).  Under ``backend="pallas"``,
``contains`` and ``probe`` run the QF structures through one fused
kernel launch and each frozen level through one ``fuse_probe`` launch
(``ops.cascade_lookup``), and the merges decode through the decode
kernel and rebuild through the build kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..core import cost_model
from ..core import fuse_filter as fuse
from ..core import quotient_filter as qf
from ..kernels import ops as kernel_ops
from . import iostats, qf_filter
from .iostats import IOCounters
from .registry import FilterImpl, UnsupportedOpError, register


class CascadeConfig(NamedTuple):
    ram_q: int  # log2 buckets of Q0
    p: int  # fingerprint bits (q + r at every level)
    fanout: int = 2  # power of two; level i has q = ram_q + (i+1)*log2(fanout)
    levels: int = 4  # static level-stack depth
    seed: int = 0
    max_load: float = 0.75
    backend: str = "reference"
    shrink_load: float = 0.5  # low watermark vs the one-shallower stack
    frozen_below: Optional[int] = None  # demote levels >= this depth to fuse form
    fuse_bits: Optional[int] = None  # frozen cell width override (default: match QF fp)

    @property
    def lb(self) -> int:
        return int(math.log2(self.fanout))

    def is_frozen(self, i: int) -> bool:
        return self.frozen_below is not None and i >= self.frozen_below

    def fuse_cfg(self, i: int) -> fuse.FuseConfig:
        """Frozen geometry of level i: sized for the level's design
        capacity, cell width matching the QF level's fp-rate target."""
        lvl = self.level_cfg(i)
        fp_bits = self.fuse_bits or cost_model.fuse_fp_bits_for(lvl.r, self.max_load)
        return fuse.make_config(lvl.capacity, self.p, fp_bits=fp_bits, seed=self.seed)

    def level_size_bytes(self, i: int) -> int:
        """Probe-structure bytes of level i (fuse table when frozen)."""
        if self.is_frozen(i):
            return self.fuse_cfg(i).size_bytes
        return self.level_cfg(i).size_bytes

    @property
    def cold_run_bytes(self) -> int:
        """Sequential-only re-expansion runs of the frozen levels —
        merge-path bytes, never touched by probes."""
        return sum(
            self.fuse_cfg(i).run_bytes for i in range(self.levels) if self.is_frozen(i)
        )

    def _cfg(self, q: int) -> qf.QFConfig:
        return qf.QFConfig(
            q=q,
            r=self.p - q,
            slack=max(1024, (1 << q) // 64),
            seed=self.seed,
            max_load=self.max_load,
        )

    @property
    def q0_cfg(self) -> qf.QFConfig:
        return self._cfg(self.ram_q)

    def level_cfg(self, i: int) -> qf.QFConfig:
        return self._cfg(self.ram_q + (i + 1) * self.lb)

    @property
    def size_bytes(self) -> int:
        return self.q0_cfg.size_bytes + sum(
            self.level_size_bytes(i) for i in range(self.levels)
        )


class CascadeState(NamedTuple):
    q0: qf.QFState
    levels: tuple  # length cfg.levels: QFState, or FuseState where frozen
    io: IOCounters


def _check_geometry(cfg: CascadeConfig) -> None:
    if cfg.fanout < 2 or (cfg.fanout & (cfg.fanout - 1)):
        raise ValueError("fanout must be a power of two >= 2")
    if cfg.levels < 1:
        raise ValueError("need at least one disk level")
    if cfg.ram_q + cfg.levels * cfg.lb >= cfg.p:
        raise ValueError("fingerprint bits p too small for the deepest level")
    if cfg.frozen_below is not None:
        if cfg.frozen_below < 0:
            raise ValueError("frozen_below must be a depth >= 0")
        fuse.canonical_split(cfg.p)  # frozen levels carry canonical streams
        for i in range(cfg.frozen_below, cfg.levels):
            cfg.fuse_cfg(i)  # validates the per-level fuse geometry


def _empty_level(cfg: CascadeConfig, i: int, device):
    if cfg.is_frozen(i):
        return fuse.empty(cfg.fuse_cfg(i), device)
    return qf.empty(cfg.level_cfg(i), device)


def _empty_levels(cfg: CascadeConfig, device, keep=None):
    """Empty structures for every level, except ``keep = {i: state}``."""
    keep = keep or {}
    return tuple(
        keep[i] if i in keep else _empty_level(cfg, i, device)
        for i in range(cfg.levels)
    )


def make(device=None, **spec):
    cfg = CascadeConfig(**spec)
    _check_geometry(cfg)
    qf_filter._check_backend(cfg)
    device = qf.resolve_device(device)
    return cfg, CascadeState(
        q0=qf.empty(cfg.q0_cfg, device),
        levels=_empty_levels(cfg, device),
        io=iostats.zeros(device),
    )


def _canon_cfg(cfg: CascadeConfig) -> qf.QFConfig:
    """The canonical (q, r) split all cross-level streams are carried in."""
    qc, rc = fuse.canonical_split(cfg.p)
    return qf.QFConfig(q=qc, r=rc, slack=0, seed=cfg.seed, max_load=cfg.max_load)


def _stream(cfg: CascadeConfig, c: qf.QFConfig, s: qf.QFState):
    """One QF as a sorted canonical fingerprint stream ``(fq, fr, n)``."""
    fq, fr, n = qf_filter.extract_fn(cfg.backend)(c, s)
    fq, fr = qf._requotient(fq, fr, c, _canon_cfg(cfg))
    return fq, fr, n


def _level_stream(cfg: CascadeConfig, state: CascadeState, i: int):
    """Level i as a canonical stream; a frozen level streams its retained
    run directly (the re-expansion path)."""
    if cfg.is_frozen(i):
        return fuse.extract_run(cfg.fuse_cfg(i), state.levels[i])
    return _stream(cfg, cfg.level_cfg(i), state.levels[i])


def _q0_stream(cfg: CascadeConfig, state: CascadeState):
    return _stream(cfg, cfg.q0_cfg, state.q0)


def _build_level(cfg: CascadeConfig, i: int, allq, allr, total):
    """Materialize level i from a sorted canonical stream.  A frozen
    target peels it; a stream that exceeds the frozen capacity or will
    not peel sets the level's ``overflow`` flag."""
    if cfg.is_frozen(i):
        return fuse.freeze_stream(cfg.fuse_cfg(i), allq, allr, total)
    tgt = cfg.level_cfg(i)
    tq, tr = qf._requotient(allq, allr, _canon_cfg(cfg), tgt)
    return qf_filter.build_fn(cfg.backend)(tgt, tq, tr, total)


def _level_read_bytes(cfg: CascadeConfig, j: int) -> int:
    """Merge-path read bytes of consuming level j: a QF level streams its
    table, a frozen level only its run."""
    if cfg.is_frozen(j):
        return cfg.fuse_cfg(j).run_bytes
    return cfg.level_cfg(j).size_bytes


def _level_read(cfg: CascadeConfig, levels, j: int) -> torch.Tensor:
    """:func:`_level_read_bytes` of level j if it is non-empty, else 0."""
    dev = levels[j].n.device
    size = iostats.f32(_level_read_bytes(cfg, j), dev)
    return torch.where(levels[j].n > 0, size, iostats.f32(0, dev))


def _level_write_bytes(cfg: CascadeConfig, i: int) -> int:
    """Bytes a merge writes into level i: its table, and a frozen level's run."""
    run = cfg.fuse_cfg(i).run_bytes if cfg.is_frozen(i) else 0
    return cfg.level_size_bytes(i) + run


def _collapse_into(cfg: CascadeConfig, state: CascadeState, i: int) -> CascadeState:
    """Merge Q0..Q_i into a fresh Q_i; levels above i empty (paper Fig. 5)."""
    with tracing.span(f"cascade.collapse.L{i}"):
        dev = state.q0.n.device
        with tracing.span("cascade.merge_streams"):
            parts = [_q0_stream(cfg, state)] + [
                _level_stream(cfg, state, j) for j in range(i + 1)
            ]
            allq, allr, total = qf.merge_streams_many(parts)
        overflow = state.q0.overflow
        for j in range(i + 1):
            overflow = overflow | state.levels[j].overflow
        merged = _build_level(cfg, i, allq, allr, total)
        merged = merged._replace(overflow=merged.overflow | overflow)
        # I/O: stream each participating non-empty disk level in, target out
        read = iostats.f32(0, dev)
        for j in range(i + 1):
            read = read + _level_read(cfg, state.levels, j)
        io = state.io._replace(
            seq_read_bytes=state.io.seq_read_bytes + read,
            seq_write_bytes=state.io.seq_write_bytes
            + iostats.f32(_level_write_bytes(cfg, i), dev),
            flushes=state.io.flushes + 1,
            merges=state.io.merges + 1,
        )
        keep = {j: state.levels[j] for j in range(i + 1, cfg.levels)}
        keep[i] = merged
        levels = _empty_levels(cfg, dev, keep)
        return CascadeState(q0=qf.empty(cfg.q0_cfg, dev), levels=levels, io=io)


def _level_caps(cfg: CascadeConfig, dev) -> torch.Tensor:
    """Each level's capacity, int32 (levels,), filled in on ``dev``: a
    tensor of host numbers would be a synchronizing copy on the card."""
    return torch.stack([
        torch.full((), cfg.level_cfg(i).capacity, dtype=torch.int32, device=dev)
        for i in range(cfg.levels)
    ])


def _collapse_target(cfg: CascadeConfig, state: CascadeState, full) -> int:
    """The level Q0 collapses into, or ``cfg.levels`` for none.

    The first level whose capacity holds Q0 and every level above it;
    read to the host once per insert batch.
    """
    L = cfg.levels
    ns = torch.stack([s.n for s in state.levels])
    cum = state.q0.n + torch.cumsum(ns, 0, dtype=torch.int32)
    fits = cum <= _level_caps(cfg, cum.device)
    target = fits.to(torch.int32).argmax()  # first fitting level
    target = torch.where(full & fits.any(), target, L)
    with tracing.span("host_read.cascade._collapse_target"):
        return int(target)


def insert(cfg: CascadeConfig, state, keys, k=None) -> CascadeState:
    """Insert a batch into Q0; merge down once Q0 is full."""
    q0 = qf_filter.insert_keys(cfg.q0_cfg, cfg.backend, state.q0, keys, k)
    state = state._replace(q0=q0)
    full = qf.load(cfg.q0_cfg, q0) >= cfg.max_load
    i = _collapse_target(cfg, state, full)
    return _collapse_into(cfg, state, i) if i < cfg.levels else state


def _qf_contains(cfg: CascadeConfig, c: qf.QFConfig, s: qf.QFState, keys):
    """Reference-path membership in one QF; empty ones answer no."""
    if not bool(s.n > 0):
        return torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    return qf_filter.contains_keys(c, cfg.backend, s, keys)


def _level_contains(cfg: CascadeConfig, state, i: int, keys):
    if cfg.is_frozen(i):  # the fuse lookup carries its own n > 0 guard
        return fuse.contains(cfg.fuse_cfg(i), state.levels[i], keys)
    return _qf_contains(cfg, cfg.level_cfg(i), state.levels[i], keys)


def _structure_hits(cfg: CascadeConfig, state, keys):
    """``(q0_hit, [hit per level])``: one fused QF kernel pass and one
    fuse probe per frozen level under ``backend="pallas"``, one plain
    lookup per structure otherwise."""
    if cfg.backend == "pallas":
        qf_ix = [i for i in range(cfg.levels) if not cfg.is_frozen(i)]
        fz_ix = [i for i in range(cfg.levels) if cfg.is_frozen(i)]
        hits = kernel_ops.cascade_lookup(
            (cfg.q0_cfg,) + tuple(cfg.level_cfg(i) for i in qf_ix),
            (state.q0,) + tuple(state.levels[i] for i in qf_ix),
            tuple(cfg.fuse_cfg(i) for i in fz_ix),
            tuple(state.levels[i] for i in fz_ix),
            keys,
        )
        per_level = dict(zip(qf_ix + fz_ix, hits[1:]))
        return hits[0], [per_level[i] for i in range(cfg.levels)]
    q0_hit = _qf_contains(cfg, cfg.q0_cfg, state.q0, keys)
    return q0_hit, [_level_contains(cfg, state, i, keys) for i in range(cfg.levels)]


def contains(cfg: CascadeConfig, state, keys):
    hit, lvl_hits = _structure_hits(cfg, state, keys)
    with tracing.span("cascade.combine"):
        for h in lvl_hits:
            hit = hit | h
    return hit


def probe(cfg: CascadeConfig, state, keys):
    """Lookup with the paper's schedule: per query still unresolved at a
    non-empty disk level, one random page read (QF cluster) or
    ``cost_model.FUSE_PROBE_READS`` gathers (frozen level), top-down
    short-circuit.  Matches ``cost_model.cascade_probe_reads``."""
    hit, lvl_hits = _structure_hits(cfg, state, keys)
    reads = torch.zeros((), dtype=torch.int32, device=hit.device)
    for i in range(cfg.levels):
        pending = ~hit
        per_query = cost_model.QF_PROBE_READS
        if cfg.is_frozen(i):
            per_query = cost_model.FUSE_PROBE_READS
        reads = reads + torch.where(
            state.levels[i].n > 0,
            per_query * pending.sum(dtype=torch.int32),
            0,
        )
        hit = hit | (pending & lvl_hits[i])
    io = state.io._replace(rand_page_reads=state.io.rand_page_reads + reads)
    return state._replace(io=io), hit


def delete(cfg: CascadeConfig, state, keys, k=None) -> CascadeState:
    """Remove one copy per key from the topmost structure holding it.

    The j-th batch occurrence of a key targets the j-th stored copy in
    top-down order.  Disk-level deletes charge one random page read per
    key targeted at a non-empty level and one random page write per
    copy removed; Q0 deletes are RAM-only and free.  A frozen cascade
    refuses deletes: a fuse table cannot unlink a key."""
    if cfg.frozen_below is not None:
        raise UnsupportedOpError("cascade", "delete", _FROZEN_DELETE_HINT)
    valid = qf_filter.valid_mask(keys, k)
    structures = [(cfg.q0_cfg, state.q0)] + [
        (cfg.level_cfg(i), state.levels[i]) for i in range(cfg.levels)
    ]
    fq0, fr0 = qf.fingerprints(cfg.q0_cfg, keys)
    rank = qf_filter.batch_occurrence_rank(fq0, fr0, valid)
    cum = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    out = []
    reads = torch.zeros((), dtype=torch.int32, device=keys.device)
    writes = torch.zeros((), dtype=torch.int32, device=keys.device)
    for lvl, (c, s) in enumerate(structures):
        fq, fr = qf.fingerprints(c, keys)
        cnt = qf_filter.multiplicity(c, cfg.backend, s, fq, fr)
        todel = valid & (rank >= cum) & (rank < cum + cnt)
        new = qf_filter.delete_masked(c, cfg.backend, s, fq, fr, todel)
        if lvl > 0:  # disk-resident level
            reads = reads + torch.where(s.n > 0, todel.sum(dtype=torch.int32), 0)
            writes = writes + (s.n - new.n)
        out.append(new)
        cum = cum + cnt
    io = state.io._replace(
        rand_page_reads=state.io.rand_page_reads + reads,
        rand_page_writes=state.io.rand_page_writes + writes,
    )
    return CascadeState(q0=out[0], levels=tuple(out[1:]), io=io)


def merge(cfg: CascadeConfig, sa, sb) -> CascadeState:
    """Union of two cascades (same cfg) as ONE streaming pass into the
    smallest level that fits the combined count (paper Fig. 5's k-way
    merge).  If even the bottom level cannot hold the union, the merge
    streams into the bottom and its ``overflow`` flag reports it."""
    L = cfg.levels
    dev = sa.q0.n.device
    parts = [_q0_stream(cfg, sa), _q0_stream(cfg, sb)]
    for j in range(L):
        parts.append(_level_stream(cfg, sa, j))
        parts.append(_level_stream(cfg, sb, j))
    allq, allr, total = qf.merge_streams_many(parts)
    overflow = sa.q0.overflow | sb.q0.overflow
    for s in (sa, sb):
        for lv in s.levels:
            overflow = overflow | lv.overflow

    read = iostats.f32(0, dev)
    for j in range(L):
        for s in (sa, sb):
            read = read + _level_read(cfg, s.levels, j)
    io = iostats.add(sa.io, sb.io)
    io = io._replace(seq_read_bytes=io.seq_read_bytes + read, merges=io.merges + 1)

    fits = total <= _level_caps(cfg, dev)
    target = torch.where(fits.any(), fits.to(torch.int32).argmax(), L - 1)
    with tracing.span("host_read.cascade.merge"):
        i = int(target)
    merged = _build_level(cfg, i, allq, allr, total)
    merged = merged._replace(overflow=merged.overflow | overflow)
    written = iostats.f32(_level_write_bytes(cfg, i), dev)
    io = io._replace(seq_write_bytes=io.seq_write_bytes + written)
    return CascadeState(
        q0=qf.empty(cfg.q0_cfg, dev),
        levels=_empty_levels(cfg, dev, {i: merged}),
        io=io,
    )


def _host_counts(state: CascadeState):
    """Every structure's count and overflow flag, Q0 first, read to the
    host in one batched transfer."""
    structures = [state.q0, *state.levels]
    ns = torch.stack([s.n for s in structures])
    ovf = torch.stack([s.overflow for s in structures]).to(torch.int32)
    host = torch.cat([ns, ovf]).tolist()
    return host[: len(structures)], any(host[len(structures) :])


def _all_streams(cfg: CascadeConfig, state: CascadeState):
    """Every component of one cascade as canonical streams, plus the
    merge-path read bytes and the or'd overflow flag (host values).
    Frozen levels stream their retained runs."""
    ns, overflow = _host_counts(state)
    parts = [_q0_stream(cfg, state)]
    read = 0.0
    for j in range(cfg.levels):
        parts.append(_level_stream(cfg, state, j))
        if ns[j + 1] > 0:
            read += _level_read_bytes(cfg, j)
    return parts, read, overflow


def _fitting_level(cfg: CascadeConfig, total: int) -> int:
    """The smallest level whose capacity holds ``total``, else the bottom."""
    return next(
        (i for i in range(cfg.levels) if total <= cfg.level_cfg(i).capacity),
        cfg.levels - 1,
    )


def _restream_host(new_cfg: CascadeConfig, parts, io, overflow: bool):
    """Collapse canonical ``(fq, fr, n)`` streams into the smallest fitting
    level of ``new_cfg`` (the tail of the geometry-changing resize).  A
    frozen target is peeled again from the merged stream."""
    dev = parts[0][0].device
    total = int(sum(p[2] for p in parts))  # one host read
    target = _fitting_level(new_cfg, total)
    if new_cfg.is_frozen(target) and total > new_cfg.fuse_cfg(target).capacity:
        raise ValueError(
            f"union of {total} keys exceeds the bottom frozen level's "
            f"capacity {new_cfg.fuse_cfg(target).capacity}; grow/resize first"
        )
    allq, allr, _ = qf.merge_streams_many(parts)
    merged = _build_level(new_cfg, target, allq, allr, total)
    merged = merged._replace(overflow=merged.overflow | overflow)
    io = io._replace(
        seq_write_bytes=io.seq_write_bytes
        + iostats.f32(_level_write_bytes(new_cfg, target), dev),
        merges=io.merges + 1,
    )
    levels = _empty_levels(new_cfg, dev, {target: merged})
    return CascadeState(q0=qf.empty(new_cfg.q0_cfg, dev), levels=levels, io=io)


def needs_resize(cfg: CascadeConfig, state):
    """Bool scalar: a full Q0 could fail to collapse anywhere, i.e. Q0's
    capacity plus everything on disk no longer fits the bottom level.
    Q0's actual count is taken when a batch overshot its capacity."""
    ns = torch.stack([s.n for s in state.levels])
    q0_worst = state.q0.n.clamp(min=cfg.q0_cfg.capacity)
    bottom = cfg.level_cfg(cfg.levels - 1).capacity
    return q0_worst + ns.sum(dtype=torch.int32) > bottom


def grow(cfg: CascadeConfig, state):
    """Deepen the level stack by one.  The new bottom level starts empty,
    so no data moves; the collapse that fills it pays for it."""
    new_cfg = cfg._replace(levels=cfg.levels + 1)
    _check_geometry(new_cfg)
    dev = state.q0.n.device
    return new_cfg, CascadeState(
        q0=state.q0,
        levels=state.levels + (_empty_level(new_cfg, cfg.levels, dev),),
        io=state.io._replace(resizes=state.io.resizes + 1),
    )


def needs_shrink(cfg: CascadeConfig, state):
    """Bool scalar: the deepest level is empty and the rest (Q0 at its
    worst-case fill, as in ``needs_resize``) fits the one-shallower stack
    at the low watermark, so popping a level cannot re-trip growth."""
    if cfg.levels <= 1:
        return torch.zeros((), dtype=torch.bool, device=state.q0.n.device)
    ns = torch.stack([s.n for s in state.levels])
    q0_worst = state.q0.n.clamp(min=cfg.q0_cfg.capacity)
    total = q0_worst + ns.sum(dtype=torch.int32)
    fits = total <= int(cfg.shrink_load * cfg.level_cfg(cfg.levels - 2).capacity)
    return (state.levels[-1].n == 0) & fits


def shrink(cfg: CascadeConfig, state):
    """Pop the (empty) deepest level: the inverse of ``grow``, and free."""
    if cfg.levels <= 1:
        raise ValueError("cannot shrink a single-level cascade")
    if int(state.levels[-1].n) != 0:
        raise ValueError("deepest level is non-empty; collapse/delete first")
    new_cfg = cfg._replace(levels=cfg.levels - 1)
    return new_cfg, CascadeState(
        q0=state.q0,
        levels=state.levels[:-1],
        io=state.io._replace(resizes=state.io.resizes + 1),
    )


def resize(cfg: CascadeConfig, state, levels: int = None, fanout: int = None):
    """Re-shape the hierarchy: deepen the stack and/or change the fanout.

    Deepening with the fanout unchanged appends empty levels (free).
    Any other change re-streams the whole cascade once into the smallest
    new level that fits the total count, charged to ``IOCounters``;
    frozen levels re-expand from their runs, and a frozen target peels.
    """
    new_cfg = cfg._replace(
        levels=cfg.levels if levels is None else levels,
        fanout=cfg.fanout if fanout is None else fanout,
    )
    _check_geometry(new_cfg)
    dev = state.q0.n.device
    if new_cfg.fanout == cfg.fanout and new_cfg.levels >= cfg.levels:
        extra = tuple(
            _empty_level(new_cfg, i, dev) for i in range(cfg.levels, new_cfg.levels)
        )
        return new_cfg, CascadeState(
            q0=state.q0,
            levels=state.levels + extra,
            io=state.io._replace(resizes=state.io.resizes + 1),
        )
    if cfg.frozen_below is not None:
        parts, read, overflow = _all_streams(cfg, state)
        io = state.io._replace(
            seq_read_bytes=state.io.seq_read_bytes + iostats.f32(read, dev),
            resizes=state.io.resizes + 1,
        )
        return new_cfg, _restream_host(new_cfg, parts, io, overflow)
    # geometry change: one streaming pass into the smallest fitting level
    ns, _ = _host_counts(state)
    target = _fitting_level(new_cfg, sum(ns))
    parts = [(cfg.q0_cfg, state.q0)] + [
        (cfg.level_cfg(j), state.levels[j]) for j in range(cfg.levels)
    ]
    tgt = new_cfg.level_cfg(target)
    merged = qf.multi_merge(
        tgt, parts, build=qf_filter.build_fn(cfg.backend),
        extract=qf_filter.extract_fn(cfg.backend),
    )
    read = iostats.f32(0, dev)
    for j in range(cfg.levels):
        read = read + _level_read(cfg, state.levels, j)
    io = state.io._replace(
        seq_read_bytes=state.io.seq_read_bytes + read,
        seq_write_bytes=state.io.seq_write_bytes + iostats.f32(tgt.size_bytes, dev),
        resizes=state.io.resizes + 1,
        merges=state.io.merges + 1,
    )
    new_levels = _empty_levels(new_cfg, dev, {target: merged})
    return new_cfg, CascadeState(
        q0=qf.empty(new_cfg.q0_cfg, dev), levels=new_levels, io=io
    )


def stats(cfg: CascadeConfig, state):
    ns = torch.stack([s.n for s in state.levels])
    out = {
        "n": state.q0.n + ns.sum(dtype=torch.int32),
        "q0_load": qf.load(cfg.q0_cfg, state.q0),
        "level_counts": ns,
        "nonempty_levels": (ns > 0).sum(dtype=torch.int32),
        "overflow": state.q0.overflow
        | torch.stack([s.overflow for s in state.levels]).any(),
        "size_bytes": cfg.size_bytes,
        **state.io._asdict(),
    }
    if cfg.frozen_below is not None:
        frozen = [i for i in range(cfg.levels) if cfg.is_frozen(i)]
        out["frozen_levels"] = len(frozen)
        out["frozen_size_bytes"] = sum(cfg.level_size_bytes(i) for i in frozen)
        out["cold_run_bytes"] = cfg.cold_run_bytes
    return out


_FROZEN_DELETE_HINT = (
    "frozen_below cascades cannot unlink keys from demoted (binary-fuse) "
    "levels; use an all-QF cascade when the cold tier must support deletes"
)

IMPL = register(
    FilterImpl(
        name="cascade",
        paper_section="§4 (cascade filter: COLA-style QF hierarchy on flash)",
        cfg_cls=CascadeConfig,
        make=make,
        insert=insert,
        contains=contains,
        stats=stats,
        delete=delete,
        merge=merge,
        probe=probe,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
        can_delete=lambda cfg: cfg.frozen_below is None,
        op_hints={
            "delete": "frozen_below cascades cannot unlink keys from "
            "demoted (binary-fuse) levels",
        },
    )
)
