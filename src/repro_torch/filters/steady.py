"""Steady-state quotient filter: always-on write buffer + background settle.

The port of ``repro.filters.steady``.  Every insert lands in a small
buffer QF (O(buffer) always), and the fold into the main table happens
as background *settle ticks*, the paper's RAM-buffer trick (§4) kept on
all the time:

* **open**: when the buffer crosses its watermark (``settle_load``) and
  no settle is running, the buffer decodes into a small sorted stream;
  the table's own sorted stream is the ``out`` planes retained from the
  previous settle, so no O(table) extract runs on the insert path.
  Paths that change the table behind the planes' back (``delete``, a
  forced settle, ``from_flat``) drop ``clean``, and the next open pays
  one extract (``qf_filter.extract_fn``).  The table planes then reset empty;
* **drain**: each later insert rank-merges one ``chunk`` window of the
  two sorted streams (``lex_searchsorted`` ranks, no sort: the k
  smallest entries of two sorted streams lie within the first k of
  each) and appends it with ``kernels.ops.build_chunk`` (one
  ``qf_build_span`` launch on the card), materializing it into ``out``.
  When the buffer passes 3/4 full, ticks widen to ``pressure`` chunks.

Membership is exact at every cursor: drained entries answer from the
partial table, the pending suffixes of the two streams from binary
searches, fresh keys from the buffer.

The JAX package decides the three branches of an insert (forced settle,
open, pressure) with ``lax.cond`` on the device.  All three follow from
the state before the call, so here an insert reads the buffer's count,
the idle flag and ``clean`` in one host transfer, and nothing else;
``contains``, ``stats`` and a drain tick read nothing.  The drain
appends into the table's planes and writes the ``out`` planes in place
(the JAX package donates the state to its jitted step), so an insert
consumes its argument: use the returned state.

The streams keep the port's convention, int64 holding the unsigned
values; ``filters.to_numpy`` gives them back as the JAX package's
int32/uint32 leaves.  Structural ops (``delete``/``merge``/``resize``/
``grow``/``shrink``) settle fully first; ``filters.auto_scale`` grows
the table through the chunked ``incremental_resize`` migration instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..core import quotient_filter as qf
from ..kernels import ops as kops
from . import iostats, qf_filter
from .iostats import IOCounters
from .qf_filter import QFilterConfig
from .registry import FilterImpl, register


class SteadyQFConfig(NamedTuple):
    """Flat-QF geometry plus the steady-state write-buffer knobs."""

    q: int
    r: int
    buf_q: int = 0  # write-buffer buckets; 0 = auto (max(8, q - 3))
    slack: int = 1024
    seed: int = 0
    max_load: float = 0.75
    backend: str = "reference"
    window: int = 256
    shrink_load: float = 0.4
    chunk: int = 256  # stream entries drained per insert tick
    settle_load: float = 0.5  # buffer load that opens a settle
    pressure: int = 8  # tick multiplier once the buffer is 3/4 full

    @property
    def flat(self) -> QFilterConfig:
        """The equivalent flat-QF config (structural ops delegate here)."""
        return QFilterConfig(
            q=self.q,
            r=self.r,
            slack=self.slack,
            seed=self.seed,
            max_load=self.max_load,
            backend=self.backend,
            window=self.window,
            shrink_load=self.shrink_load,
        )

    @property
    def table(self) -> qf.QFConfig:
        return self.flat.core

    @property
    def buf(self) -> qf.QFConfig:
        # the buffer re-splits the same p-bit fingerprints at buf_q, so
        # requotienting into the table split is lossless and monotone
        return qf.QFConfig(
            q=self.buf_q,
            r=self.q + self.r - self.buf_q,
            slack=max(64, self.slack // 8),
            seed=self.seed,
            max_load=self.max_load,
        )

    @property
    def stream_len(self) -> int:
        """Settle-stream length: a full table + buffer fold must fit."""
        return self.table.total_slots + self.buf.total_slots


class SteadyQFState(NamedTuple):
    """Main table + write buffer + in-flight settle streams.

    Every stream plane is a sorted valid prefix followed by sentinel
    padding.  ``out`` holds the merged stream the drain has emitted so
    far; once a settle completes it equals the table's sorted multiset
    and ``clean`` goes up.  The fields are in the JAX pytree's order.
    """

    table: qf.QFState  # holds the drained stream prefix when settling
    buf: qf.QFState  # every fresh insert lands here first
    src_fq: torch.Tensor  # int64 (table slots): table-side settle stream
    src_fr: torch.Tensor  # int64
    src_n: torch.Tensor  # int32 scalar: valid prefix of the table stream
    cursor: torch.Tensor  # int32 scalar: [cursor, src_n) still pending
    bsrc_fq: torch.Tensor  # int64 (buffer slots): buffer-side settle stream
    bsrc_fr: torch.Tensor  # int64 (already in the table split)
    bsrc_n: torch.Tensor  # int32 scalar: valid prefix of the buffer stream
    bcursor: torch.Tensor  # int32 scalar: [bcursor, bsrc_n) still pending
    out_fq: torch.Tensor  # int64 (table slots): merged stream, drain-built
    out_fr: torch.Tensor  # int64
    clean: torch.Tensor  # bool scalar: out[:table.n] == sorted table
    last_pos: torch.Tensor  # int32 carry of the append (-1 initially)
    last_fq: torch.Tensor  # int32 carry of the append (-1 initially)
    io: IOCounters


def _resolve_buf_q(cfg: SteadyQFConfig) -> SteadyQFConfig:
    buf_q = cfg.buf_q or max(8, cfg.q - 3)
    return cfg._replace(buf_q=buf_q)


def _check_geometry(cfg: SteadyQFConfig) -> None:
    qf_filter._check_backend(cfg)
    if not (1 <= cfg.buf_q < cfg.q):
        raise ValueError(f"buf_q must be in [1, q), got {cfg.buf_q} vs q={cfg.q}")
    max_r = 31 if cfg.backend == "pallas" else 32
    if cfg.q + cfg.r - cfg.buf_q > max_r:
        raise ValueError(
            f"buffer remainder p - buf_q = {cfg.q + cfg.r - cfg.buf_q} "
            f"exceeds {max_r} bits; raise buf_q"
        )
    if cfg.chunk < 1 or cfg.pressure < 1:
        raise ValueError("chunk and pressure must be positive")
    if not (0.0 < cfg.settle_load <= 1.0):
        raise ValueError("settle_load must be in (0, 1]")


def _sentinel_planes(n: int, device):
    return (
        torch.full((n,), qf.INT32_MAX, dtype=torch.int64, device=device),
        torch.full((n,), qf.UINT32_MAX, dtype=torch.int64, device=device),
    )


def _scalar(value, dtype, device) -> torch.Tensor:
    # a fill, not a copy from the host: no sync on the card
    return torch.full((), value, dtype=dtype, device=device)


def from_flat(cfg: SteadyQFConfig, table: qf.QFState, io=None) -> SteadyQFState:
    """Wrap a settled flat-QF table as an idle steady state.

    The wrapped table's sorted planes are unknown, so ``clean`` is down
    (unless the table is empty: sentinels describe it exactly) and the
    first settle pays one extract."""
    dev = table.n.device
    fq, fr = _sentinel_planes(cfg.table.total_slots, dev)
    ofq, ofr = _sentinel_planes(cfg.table.total_slots, dev)
    bq, br = _sentinel_planes(cfg.buf.total_slots, dev)
    return SteadyQFState(
        table=table,
        buf=qf.empty(cfg.buf, dev),
        src_fq=fq,
        src_fr=fr,
        src_n=_scalar(0, torch.int32, dev),
        cursor=_scalar(0, torch.int32, dev),
        bsrc_fq=bq,
        bsrc_fr=br,
        bsrc_n=_scalar(0, torch.int32, dev),
        bcursor=_scalar(0, torch.int32, dev),
        out_fq=ofq,
        out_fr=ofr,
        clean=table.n == 0,
        last_pos=_scalar(-1, torch.int32, dev),
        last_fq=_scalar(-1, torch.int32, dev),
        io=iostats.zeros(dev) if io is None else io,
    )


def make(device=None, **spec):
    cfg = _resolve_buf_q(SteadyQFConfig(**spec))
    _check_geometry(cfg)
    return cfg, from_flat(cfg, qf.empty(cfg.table, device))


# ---------------------------------------------------------------------------
# Settle machinery
# ---------------------------------------------------------------------------


def _open_settle(cfg: SteadyQFConfig, s: SteadyQFState, clean: bool) -> SteadyQFState:
    """Arm the two settle streams; reset table and buffer planes.

    O(buffer): the buffer decodes and the table's sorted stream is the
    retained ``out`` planes.  Only when ``clean`` (the host's copy of
    ``s.clean``) is down does it pay the O(table) decode."""
    dev = s.cursor.device
    if clean:
        tq, tr = s.out_fq, s.out_fr
    else:
        tq, tr, _ = qf_filter.extract_fn(cfg.backend)(cfg.table, s.table)
    bq, br, bn = qf_filter.extract_fn(cfg.backend)(cfg.buf, s.buf)
    bq, br = qf._requotient(bq, br, cfg.buf, cfg.table)
    io = s.io._replace(flushes=s.io.flushes + 1, settles=s.io.settles + 1)
    ofq, ofr = _sentinel_planes(cfg.table.total_slots, dev)
    return SteadyQFState(
        table=qf.empty(cfg.table, dev)._replace(
            overflow=s.table.overflow | s.buf.overflow
        ),
        buf=qf.empty(cfg.buf, dev),
        src_fq=tq,
        src_fr=tr,
        src_n=s.table.n,
        cursor=_scalar(0, torch.int32, dev),
        bsrc_fq=bq,
        bsrc_fr=br,
        bsrc_n=bn,
        bcursor=_scalar(0, torch.int32, dev),
        out_fq=ofq,
        out_fr=ofr,
        clean=_scalar(False, torch.bool, dev),
        last_pos=_scalar(-1, torch.int32, dev),
        last_fq=_scalar(-1, torch.int32, dev),
        io=io,
    )


def _window(fq, fr, cursor, n, span: int):
    """Sentinel-padded gather of the next ``span`` pending entries."""
    idx = cursor + torch.arange(span, dtype=torch.int32, device=fq.device)
    valid = idx < n
    gi = idx.clamp(0, fq.shape[0] - 1).to(torch.int64)
    wq = torch.where(valid, fq[gi], qf.INT32_MAX)
    wr = torch.where(valid, fr[gi], qf.UINT32_MAX)
    return wq, wr, valid.sum(dtype=torch.int32)


def _merge_window(aq, ar, na, bq, br, nb, span: int):
    """Rank-merge two sorted sentinel-padded windows; count how many of
    each side land in the emitted ``span`` prefix (the cursors' advance)."""
    ra, rb = qf.merge_ranks(aq, ar, na, bq, br, nb)
    mq, mr = qf.merge_streams(aq, ar, na, bq, br, nb, ranks=(ra, rb))
    ia = torch.arange(ra.shape[0], device=aq.device)
    ib = torch.arange(rb.shape[0], device=aq.device)
    adv_a = ((ia < na) & (ra < span)).sum(dtype=torch.int32)
    adv_b = ((ib < nb) & (rb < span)).sum(dtype=torch.int32)
    return mq[:span], mr[:span], adv_a, adv_b


def _put_prefix(plane, start, values, k):
    """``plane[start + i] = values[i]`` for ``i < k`` inside the plane, in
    place, with ``start``/``k`` scalar tensors left on the device.

    The JAX package scatters with ``mode="drop"``; here every other lane
    adds zero to a clamped index, so duplicate indices are harmless and
    nothing past ``k`` is written."""
    t = plane.shape[0]
    lane = torch.arange(values.shape[0], device=plane.device)
    idx = start.to(torch.int64) + lane
    keep = (lane < k) & (idx < t)
    idx = idx.clamp(max=t - 1)
    return plane.index_add_(0, idx, torch.where(keep, values - plane[idx], 0))


def _drain(cfg: SteadyQFConfig, s: SteadyQFState, steps: int) -> SteadyQFState:
    """Merge up to ``steps * chunk`` pending stream entries into the table.

    One rank-merge of two windows feeds the left-to-right append (one
    ``qf_build_span`` launch on the card) and the ``out`` planes, so a
    completed settle leaves the table's sorted stream behind for the
    next open.  A masked no-op once drained.  Writes the table's and the
    ``out`` planes in place."""
    span = cfg.chunk * steps
    aq, ar, na = _window(s.src_fq, s.src_fr, s.cursor, s.src_n, span)
    bq, br, nb = _window(s.bsrc_fq, s.bsrc_fr, s.bcursor, s.bsrc_n, span)
    mq, mr, adv_a, adv_b = _merge_window(aq, ar, na, bq, br, nb, span)
    moved = adv_a + adv_b
    append = kops.build_chunk if steps == 1 else kops.build_span
    table, last_pos, last_fq = append(
        cfg.table, s.table, mq, mr, moved, s.last_pos, s.last_fq
    )
    # only the emitted entries enter the retained planes: after settle_all
    # the cursors are 0, and sentinels must not overwrite the prefix
    done = s.cursor + s.bcursor
    out_fq = _put_prefix(s.out_fq, done, mq, moved)
    out_fr = _put_prefix(s.out_fr, done, mr, moved)
    cursor = s.cursor + adv_a
    bcursor = s.bcursor + adv_b
    complete = (cursor >= s.src_n) & (bcursor >= s.bsrc_n)
    moved_bytes = moved.to(torch.float32) * (cfg.table.bits_per_slot / 8.0)
    io = s.io._replace(
        seq_read_bytes=s.io.seq_read_bytes + moved_bytes,
        seq_write_bytes=s.io.seq_write_bytes + moved_bytes,
        migrate_chunks=s.io.migrate_chunks + (moved + cfg.chunk - 1) // cfg.chunk,
    )
    return s._replace(
        cursor=cursor,
        bcursor=bcursor,
        table=table,
        out_fq=out_fq,
        out_fr=out_fr,
        clean=s.clean | ((moved > 0) & complete),
        last_pos=last_pos,
        last_fq=last_fq,
        io=io,
    )


def _watermark(cfg: SteadyQFConfig) -> int:
    return max(1, int(cfg.settle_load * cfg.buf.capacity))


def _pressure_mark(cfg: SteadyQFConfig) -> int:
    return max(1, (3 * cfg.buf.capacity) // 4)


def _forced(cfg: SteadyQFConfig, s: SteadyQFState, keys, k) -> SteadyQFState:
    """The batch would overflow the buffer: settle everything now and take
    the batch straight into the table (exact for any batch size, at
    stop-the-world cost; size ``buf_q`` for the batch)."""
    s = settle_all(cfg, s)
    table = qf_filter.insert_keys(cfg.table, cfg.backend, s.table, keys, k)
    # the insert bypassed the retained planes; this path is already
    # O(table), so re-extract and keep the next open O(buffer)
    ofq, ofr, _ = qf_filter.extract_fn(cfg.backend)(cfg.table, table)
    dev = table.n.device
    return s._replace(
        table=table, out_fq=ofq, out_fr=ofr, clean=_scalar(True, torch.bool, dev)
    )


def insert(cfg: SteadyQFConfig, state: SteadyQFState, keys, k=None):
    """O(buffer) insert + one bounded settle tick.

    One host read of the buffer's count, the idle flag and ``clean``
    (and ``k`` when it is a tensor) decides the branches; no call pays
    more than the buffer insert plus ``pressure * chunk`` stream moves
    unless the batch overflows the buffer.  Consumes ``state``.
    """
    idle = (state.cursor >= state.src_n) & (state.bcursor >= state.bsrc_n)
    flags = [state.buf.n, idle.to(torch.int32), state.clean.to(torch.int32)]
    if torch.is_tensor(k):
        flags.append(k.to(device=state.buf.n.device, dtype=torch.int32).reshape(()))
    flags = torch.stack(flags)
    with tracing.span("host_read.steady.insert"):
        flags = flags.tolist()  # the insert's one host read
    buffered, idle, clean = flags[0], bool(flags[1]), bool(flags[2])
    kk = flags[3] if torch.is_tensor(k) else keys.shape[0] if k is None else int(k)
    if buffered + kk > cfg.buf.capacity:
        return _forced(cfg, state, keys, k)
    # open a settle once the buffer crossed its watermark and the previous
    # streams are retired (settles never overlap) ...
    opened = idle and buffered >= _watermark(cfg)
    if opened:
        state = _open_settle(cfg, state, clean)
    # ... run one tick, widened under buffer pressure (an idle state's
    # tick moves nothing and changes nothing, so it is skipped) ...
    if not idle or opened:
        pressure = not opened and buffered >= _pressure_mark(cfg)
        state = _drain(cfg, state, cfg.pressure if pressure else 1)
    # ... then the insert itself: O(buffer)
    buf = qf_filter.insert_keys(cfg.buf, cfg.backend, state.buf, keys, k)
    return state._replace(buf=buf)


def _suffix_hit(fq_plane, fr_plane, cursor, fq, fr):
    """Any occurrence of (fq, fr) in the still-pending stream suffix."""
    lo = qf.lex_searchsorted(fq_plane, fr_plane, fq, fr, "left")
    hi = qf.lex_searchsorted(fq_plane, fr_plane, fq, fr, "right")
    return hi > torch.maximum(lo, cursor)


def contains(cfg: SteadyQFConfig, state: SteadyQFState, keys):
    """MAY-CONTAIN across the four disjoint slices (exact mid-settle)."""
    fq, fr = qf_filter.fingerprint_fn(cfg.backend)(cfg.table, keys)
    hit = _suffix_hit(state.src_fq, state.src_fr, state.cursor, fq, fr)
    hit = hit | _suffix_hit(state.bsrc_fq, state.bsrc_fr, state.bcursor, fq, fr)
    hit = hit | qf_filter.contains_keys(
        cfg.table, cfg.backend, state.table, keys, cfg.window
    )
    return hit | qf_filter.contains_keys(
        cfg.buf, cfg.backend, state.buf, keys, cfg.window
    )


def settle_all(cfg: SteadyQFConfig, s: SteadyQFState) -> SteadyQFState:
    """Retire the streams and fold the buffer: the table then holds the
    whole multiset.  O(table), used by the structural ops only; no host
    read."""
    # drain whatever the streams still hold in one span append
    steps = -(-cfg.stream_len // cfg.chunk)
    pending = (s.src_n - s.cursor) + (s.bsrc_n - s.bcursor)
    busy = (pending > 0) | (s.buf.n > 0)
    s = _drain(cfg, s, steps)
    # fold the buffer in with one sort-free two-stream merge + rebuild
    tq, tr, tn = qf_filter.extract_fn(cfg.backend)(cfg.table, s.table)
    bq, br, bn = qf_filter.extract_fn(cfg.backend)(cfg.buf, s.buf)
    bq, br = qf._requotient(bq, br, cfg.buf, cfg.table)
    allq, allr = qf.merge_streams(tq, tr, tn, bq, br, bn)
    table = qf_filter.build_fn(cfg.backend)(cfg.table, allq, allr, tn + bn)
    table = table._replace(overflow=table.overflow | s.table.overflow | s.buf.overflow)
    dev = tn.device
    fq, fr = _sentinel_planes(cfg.table.total_slots, dev)
    bfq, bfr = _sentinel_planes(cfg.buf.total_slots, dev)
    T = cfg.table.total_slots
    io = s.io._replace(settles=s.io.settles + busy.to(torch.int32))
    return s._replace(
        table=table,
        buf=qf.empty(cfg.buf, dev),
        src_fq=fq,
        src_fr=fr,
        src_n=_scalar(0, torch.int32, dev),
        cursor=_scalar(0, torch.int32, dev),
        bsrc_fq=bfq,
        bsrc_fr=bfr,
        bsrc_n=_scalar(0, torch.int32, dev),
        bcursor=_scalar(0, torch.int32, dev),
        # the merged stream is the table's sorted contents: retain it so
        # the next open skips the extract (n <= capacity < total_slots)
        out_fq=allq[:T],
        out_fr=allr[:T],
        clean=_scalar(True, torch.bool, dev),
        last_pos=_scalar(-1, torch.int32, dev),
        last_fq=_scalar(-1, torch.int32, dev),
        io=io,
    )


def delete(cfg: SteadyQFConfig, state: SteadyQFState, keys, k=None):
    """Settle, then delete one copy per key from the table (exact)."""
    state = settle_all(cfg, state)
    fq, fr = qf.fingerprints(cfg.table, keys)
    table = qf_filter.delete_masked(
        cfg.table, cfg.backend, state.table, fq, fr, qf_filter.valid_mask(keys, k)
    )
    # off the hot path (the settle is already O(table)): re-extract the
    # retained planes so the next open, which is on it, stays O(buffer)
    ofq, ofr, _ = qf_filter.extract_fn(cfg.backend)(cfg.table, table)
    dev = table.n.device
    return state._replace(
        table=table, out_fq=ofq, out_fr=ofr, clean=_scalar(True, torch.bool, dev)
    )


def merge(cfg: SteadyQFConfig, sa: SteadyQFState, sb: SteadyQFState):
    """Union of two steady filters (same cfg): settle both, merge tables."""
    sa = settle_all(cfg, sa)
    sb = settle_all(cfg, sb)
    core = cfg.table
    table = qf.merge(
        core, core, core, sa.table, sb.table, build=qf_filter.build_fn(cfg.backend),
        extract=qf_filter.extract_fn(cfg.backend),
    )
    io = iostats.add(sa.io, sb.io)
    io = io._replace(merges=io.merges + 1)
    return from_flat(cfg, table, io=io)


def _total(state: SteadyQFState) -> torch.Tensor:
    return (
        state.table.n
        + state.buf.n
        + (state.src_n - state.cursor)
        + (state.bsrc_n - state.bcursor)
    )


def needs_resize(cfg: SteadyQFConfig, state: SteadyQFState):
    """Bool scalar: the whole population at or over the table's max load."""
    return _total(state) >= cfg.table.capacity


def resize(cfg: SteadyQFConfig, state: SteadyQFState, new_q: int):
    """Settle, re-split the table at ``new_q``, re-wrap (host-level).

    ``buf_q`` re-derives from the new ``q``."""
    state = settle_all(cfg, state)
    flat_cfg, table = qf_filter.resize(cfg.flat, state.table, new_q)
    ncfg = _resolve_buf_q(cfg._replace(q=flat_cfg.q, r=flat_cfg.r, buf_q=0))
    _check_geometry(ncfg)
    io = state.io._replace(resizes=state.io.resizes + 1)
    return ncfg, from_flat(ncfg, table, io=io)


def grow(cfg: SteadyQFConfig, state: SteadyQFState):
    return resize(cfg, state, cfg.q + 1)


def needs_shrink(cfg: SteadyQFConfig, state: SteadyQFState):
    if not qf_filter._can_halve(cfg.flat) or cfg.q - 1 <= cfg.buf_q:
        return torch.zeros((), dtype=torch.bool, device=state.cursor.device)
    halved = cfg.table._replace(q=cfg.q - 1, r=cfg.r + 1)
    return _total(state) <= int(cfg.shrink_load * halved.capacity)


def shrink(cfg: SteadyQFConfig, state: SteadyQFState):
    if not qf_filter._can_halve(cfg.flat):
        raise ValueError(f"cannot shrink q={cfg.q}, r={cfg.r} further")
    return resize(cfg, state, cfg.q - 1)


def stats(cfg: SteadyQFConfig, state: SteadyQFState):
    return {
        "n": _total(state),
        "load": _total(state).to(torch.float32) / cfg.table.m,
        "buffered": state.buf.n,
        "pending": (state.src_n - state.cursor) + (state.bsrc_n - state.bcursor),
        "settling": (state.cursor < state.src_n) | (state.bcursor < state.bsrc_n),
        "overflow": state.table.overflow | state.buf.overflow,
        "size_bytes": cfg.table.size_bytes + cfg.buf.size_bytes,
        **state.io._asdict(),
    }


IMPL = register(
    FilterImpl(
        name="steady_qf",
        paper_section="§4 RAM buffer, kept always-on (LSM-style steady state)",
        cfg_cls=SteadyQFConfig,
        make=make,
        insert=insert,
        contains=contains,
        stats=stats,
        delete=delete,
        merge=merge,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
    )
)
