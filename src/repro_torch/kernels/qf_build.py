"""CUDA kernel: bulk quotient-filter build (slot-plane scatter).

Replaces the TPU kernel ``repro/kernels/qf_build.py::qf_build_planes``
(body ``_build_kernel``).  The TPU kernel tiled the scatter into S-slot
output tiles and reduced a (2S x S) one-hot match per tile, because
Mosaic cannot index memory dynamically.  ``csrc/qf_build.cu`` keeps the
tiles: one block per 4096-slot tile finds its items by a search (probe
positions strictly increase, quotients do not decrease), builds the
tile of all four planes in shared memory, and stores it once.

Bound on the card: bytes.  It reads three int32 words per item, as the
TPU kernel did, and writes 7 bytes per slot.  Every plane byte is
written once, 16 bytes a store, so the planes are allocated here
without the zero fill a scatter into them would need.

Two more entries of the same source share one device-side probe scan,
``csrc/qf_scan.cuh``: ``pos[i] = i + cummax(fq[i] - i)``, which the JAX
package computes with ``lax.cummax`` (XLA code in front of the TPU
kernel, ``repro/kernels/ops.py::_build_sorted`` and ``::_span_math``).
``qf_positions`` writes a whole build's positions for
``qf_build_planes``, in one pass over the stream by a decoupled
look-back across tiles (bound: bytes, the valid rows read and the int32
positions of every row written).  ``qf_build_span`` appends a sorted
span to a partly built table in place, the incremental migration's step
(``repro/kernels/ops.py::_build_span``, which runs the TPU kernel over
whole planes and ORs them into the table): it scans the span itself
with the carried ``last_pos``, writes each item's slot and marks its
bucket, and advances ``n``, ``overflow`` and the carries on the card, so
its work is O(span), no pass over the table is made and nothing is read
on the host.  Bound: bytes, the span's ``fq``/``fr`` read and 7 plane
bytes written per item.

The look-back keeps a small scratch per device and stream (a ticket, a
count and an epoch, then a status word a tile), zeroed once when it is
allocated and re-armed by each launch's last block, so no launch
clears it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from . import cuda_lib, dispatch

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p


def build_planes_plain(pos, fq, fr, n, total_slots: int):
    """Plain PyTorch version: the same planes by four masked scatters."""
    t = total_slots
    idx = torch.arange(pos.shape[0], device=pos.device)
    valid = idx < n
    slot = torch.where(valid & (pos >= 0) & (pos < t), pos, t)  # t: dump slot
    bucket = torch.where(valid & (fq >= 0) & (fq < t), fq, t)
    prev = torch.roll(fq, 1)
    rem = torch.zeros(t + 1, dtype=torch.int32, device=pos.device)
    occ = torch.zeros(t + 1, dtype=torch.bool, device=pos.device)
    shf = torch.zeros_like(occ)
    con = torch.zeros_like(occ)
    rem[slot] = fr
    occ[bucket] = True
    shf[slot] = pos != fq
    con[slot] = (idx > 0) & (prev == fq)
    return rem[:t], occ[:t], shf[:t], con[:t]


@functools.cache
def _library():
    """The loaded ``qf_build`` library, its three entries typed once."""
    lib = cuda_lib.library("qf_build")
    lib.qf_build_planes.argtypes = [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P]
    lib.qf_build_planes.restype = ctypes.c_int
    lib.qf_positions.argtypes = [_P, _P, _I64, _I64, _P, _P, _P, _P]
    lib.qf_positions.restype = ctypes.c_int
    lib.qf_build_span.argtypes = [_P] * 7 + [_I64, _I64] + [_P] * 10
    lib.qf_build_span.restype = ctypes.c_int
    return lib


def qf_build_planes(pos, fq, fr, n, total_slots: int):
    """Scatter sorted items into ``(rem, occ, shf, con)`` planes.

    ``pos``/``fq``/``fr`` are int32 (items,): probe positions, quotients
    and remainders (the uint32 bit pattern), the first ``n`` valid
    (``n`` an int32 scalar tensor), sorted: over the valid items ``fq``
    does not decrease and ``pos`` strictly increases (as
    ``quotient_filter.probe_positions`` gives them).  Valid items whose
    position is outside the planes are dropped, as the JAX scatter
    drops them; their buckets are still marked occupied.
    """
    with tracing.span("kernels.qf_build_planes"):
        for name, t in (("pos", pos), ("fq", fq), ("fr", fr), ("n", n)):
            dispatch.require(t, name, torch.int32)
        if not (pos.shape == fq.shape == fr.shape and n.dim() == 0):
            raise ValueError("pos, fq and fr must share one shape; n must be a scalar")
        if not dispatch.use_kernel(pos, fq, fr, n):
            return build_planes_plain(pos, fq, fr, n, total_slots)
        dev = pos.device
        rem = torch.empty(total_slots, dtype=torch.int32, device=dev)
        occ = torch.empty(total_slots, dtype=torch.bool, device=dev)
        shf = torch.empty_like(occ)
        con = torch.empty_like(occ)
        P = cuda_lib.ptr
        err = _library().qf_build_planes(
            P(pos), P(fq), P(fr), P(n), pos.shape[0], total_slots,
            P(rem), P(occ), P(shf), P(con), cuda_lib.stream_handle(dev),
        )
        cuda_lib.check(err, "qf_build_planes")
        qf_build_planes.launches += 1
        return rem, occ, shf, con


qf_build_planes.launches = 0


SCAN_TILE = 8192  # rows a block scans: csrc/qf_scan.cuh's SCAN_TILE
_PAST_N = -(2**31 - 1)  # the scan's value of a row at or past n
_SCRATCH: dict = {}


def _scan_scratch(device, stream, rows: int) -> torch.Tensor:
    """The look-back's scratch for launches on ``stream``: two header
    words, then a status word for each of at least ``rows``' tiles."""
    tiles = max(1, -(-rows // SCAN_TILE))
    key = (device, stream.value)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < 2 + tiles:
        # launches are ordered on the stream, so the old buffer's last
        # reader is done before the allocator hands its memory out again
        buf = torch.zeros(2 + max(2 * tiles, 1 << 15), dtype=torch.int64, device=device)
        _SCRATCH[key] = buf
    return buf


def positions_plain(fq, n, total_slots: int):
    """Plain PyTorch version of ``qf_positions``: ``quotient_filter.
    probe_positions``'s ``cummax`` scan, narrowed to int32."""
    idx = torch.arange(fq.shape[0], device=fq.device)
    valid = idx < n
    d = torch.where(valid, fq.to(torch.int64) - idx, _PAST_N)
    pos = idx + torch.cummax(d, 0).values
    overflow = (valid & (pos >= total_slots)).any()
    return pos.to(torch.int32), overflow


def qf_positions(fq, n, total_slots: int):
    """Probe positions of a sorted quotient stream, the first ``n`` valid.

    ``fq`` is int32 (rows,), as ``qf_build_planes`` takes it,
    non-decreasing over its valid rows; ``n`` an int32 scalar tensor,
    read on the card.  Returns ``(pos, overflow)``: the int32 positions
    of every row, ``i + cummax(fq - i)`` over the valid rows (a row past
    ``n`` takes ``-INT32_MAX`` into the scan), kept to their low 32 bits,
    and a bool scalar, set when a valid row lies at or past
    ``total_slots``.  Equal to ``quotient_filter.probe_positions``
    narrowed as ``ops.build_sorted`` narrows it.
    """
    with tracing.span("kernels.qf_positions"):
        dispatch.require(fq, "fq", torch.int32)
        dispatch.require(n, "n", torch.int32)
        if fq.dim() != 1 or n.dim() != 0:
            raise ValueError("fq must be 1-d, n a scalar")
        if not dispatch.use_kernel(fq, n):
            return positions_plain(fq, n, total_slots)
        rows = fq.shape[0]
        if rows >= 2**31:
            raise ValueError("the scan takes fewer than 2**31 rows")
        dev = fq.device
        pos = torch.empty(rows, dtype=torch.int32, device=dev)
        overflow = torch.empty((), dtype=torch.bool, device=dev)
        stream = cuda_lib.stream_handle(dev)
        err = _library().qf_positions(
            fq.data_ptr(), n.data_ptr(), rows, total_slots,
            _scan_scratch(dev, stream, rows).data_ptr(), pos.data_ptr(),
            overflow.data_ptr(), stream,
        )
        cuda_lib.check(err, "qf_positions")
        qf_positions.launches += 1
        return pos, overflow


qf_positions.launches = 0


def build_span_plain(fq, fr, k, n, overflow, last_pos, last_fq, rem, occ, shf, con):
    """Plain PyTorch version of ``qf_build_span``: the carried ``cummax``
    scan, then four masked scatters."""
    t = rem.shape[0]
    rows = fq.shape[0]
    idx = torch.arange(rows, device=fq.device)
    valid = idx < k
    d = torch.where(valid, fq - idx, _PAST_N)
    pos = idx + torch.maximum(last_pos + 1, torch.cummax(d, 0).values)
    keep = valid & (pos >= 0) & (pos < t)
    slot = pos[keep]
    q32 = fq.to(torch.int32)
    prev = torch.cat([last_fq.reshape(1), q32[:-1]])
    rem[slot] = fr.to(torch.int32)[keep]
    shf[slot] = (pos != fq)[keep]
    con[slot] = (q32 == prev)[keep]
    occ[fq[valid & (fq >= 0) & (fq < t)]] = True
    new_overflow = overflow | (valid & (pos >= t)).any()
    if rows == 0:
        return n + k, new_overflow, last_pos.clone(), last_fq.clone()
    last = (k - 1).clamp(0, rows - 1).reshape(1).to(torch.int64)
    new_last_pos = torch.where(k > 0, pos.index_select(0, last)[0], last_pos)
    new_last_fq = torch.where(k > 0, q32.index_select(0, last)[0], last_fq)
    return n + k, new_overflow, new_last_pos.to(torch.int32), new_last_fq


def qf_build_span(fq, fr, k, n, overflow, last_pos, last_fq, rem, occ, shf, con):
    """Append a sorted span to a partly built table, in place.

    ``fq``/``fr`` are the span's quotients and remainders, the int64
    streams of ``core`` (span,), the first ``k`` valid (``k`` an
    int32 scalar tensor, read on the card); ``n``/``overflow`` are the
    table's count (int32) and overflow flag (bool); ``last_pos``/
    ``last_fq`` (int32 scalars, -1 before the first span) are the
    position and quotient of the item appended just before the span.
    The span's positions are ``i + max(last_pos + 1, cummax(fq - i))``
    over its valid rows.  Each valid item writes ``rem[pos] = fr``,
    ``shf[pos] = pos != fq``, ``con[pos] = fq == prev`` (``prev`` is
    ``last_fq`` for item 0) and ``occ[fq] = 1`` into the given planes;
    one whose position is past the last slot is dropped and still marks
    its bucket.  Every valid quotient sorts at or after ``last_fq``.
    Returns new scalar tensors ``(n + k, overflow | a valid item past the
    last slot, last_pos, last_fq)``, the carries those of the last valid
    item (unchanged when ``k <= 0``).
    """
    args = (fq, fr, k, n, overflow, last_pos, last_fq, rem, occ, shf, con)
    _check_span(*args)  # few Python steps: the per-insert chunk is host-bound
    if not dispatch.use_kernel(*args):
        return build_span_plain(*args)
    rows = fq.shape[0]
    if rows >= 2**31:
        raise ValueError("the scan takes fewer than 2**31 rows")
    dev = fq.device
    n_out, last_pos_out, last_fq_out = torch.empty(
        3, dtype=torch.int32, device=dev).unbind()
    overflow_out = torch.empty((), dtype=torch.bool, device=dev)
    stream = cuda_lib.stream_handle(dev)
    p = [t.data_ptr() for t in args]
    err = _library().qf_build_span(
        *p[:7], rows, rem.shape[0],
        _scan_scratch(dev, stream, rows).data_ptr(), *p[7:], n_out.data_ptr(),
        overflow_out.data_ptr(), last_pos_out.data_ptr(), last_fq_out.data_ptr(), stream,
    )
    cuda_lib.check(err, "qf_build_span")
    qf_build_span.launches += 1
    return n_out, overflow_out, last_pos_out, last_fq_out


def _check_span(fq, fr, k, n, overflow, last_pos, last_fq, rem, occ, shf, con):
    """``qf_build_span``'s argument checks, in as few steps as they take."""
    i32, b8 = torch.int32, torch.bool
    if fq.dtype != torch.int64 or fr.dtype != torch.int64:
        raise TypeError(f"fq and fr must be int64, got {fq.dtype} and {fr.dtype}")
    dtypes = (k.dtype, n.dtype, last_pos.dtype, last_fq.dtype, rem.dtype,
              overflow.dtype, occ.dtype, shf.dtype, con.dtype)
    if dtypes != (i32,) * 5 + (b8,) * 4:
        raise TypeError("k, n, last_pos, last_fq and rem must be int32, overflow "
                        f"and the other planes bool; got {dtypes}")
    if k.dim() or n.dim() or overflow.dim() or last_pos.dim() or last_fq.dim():
        raise ValueError("k, n, overflow, last_pos and last_fq must be scalars")
    if fq.dim() != 1 or fr.shape != fq.shape:
        raise ValueError("fq and fr must share one 1-d shape")
    if not rem.shape == occ.shape == shf.shape == con.shape:
        raise ValueError("the four planes must share one shape")
    for t in (fq, fr, rem, occ, shf, con):
        if not t.is_contiguous():
            raise ValueError("fq, fr and the planes must be contiguous")


qf_build_span.launches = 0
