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

``qf_build_span`` is the second entry of the same source: it appends a
sorted span to a partly built table in place, the incremental
migration's step (``repro/kernels/ops.py::_build_span``, which runs the
TPU kernel over whole planes and ORs them into the table).  One thread
per item writes its slot and marks its bucket, so its work is O(span)
and no pass over the table is made.  Bound: bytes, 12 read and 7
written per item.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
    """The loaded ``qf_build`` library, its two entries typed once."""
    lib = cuda_lib.library("qf_build")
    lib.qf_build_planes.argtypes = [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P]
    lib.qf_build_planes.restype = ctypes.c_int
    lib.qf_build_span.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P]
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


def build_span_plain(pos, fq, fr, k, last_fq, rem, occ, shf, con) -> None:
    """Plain PyTorch version of ``qf_build_span``: four masked scatters."""
    t = rem.shape[0]
    valid = torch.arange(pos.shape[0], device=pos.device) < k
    prev = torch.cat([last_fq.reshape(1), fq[:-1]])
    keep = valid & (pos >= 0) & (pos < t)
    slot = pos[keep].to(torch.int64)
    rem[slot] = fr[keep]
    shf[slot] = (pos != fq)[keep]
    con[slot] = (fq == prev)[keep]
    occ[fq[valid & (fq >= 0) & (fq < t)].to(torch.int64)] = True


def qf_build_span(pos, fq, fr, k, last_fq, rem, occ, shf, con) -> None:
    """Append a sorted span to a partly built table, in place.

    ``pos``/``fq``/``fr`` are int32 (span,): probe positions, quotients
    and remainder bit patterns, the first ``k`` valid (``k`` an int32
    scalar tensor, read on the card); ``last_fq`` (int32 scalar tensor)
    is the quotient of the item appended just before the span.  Each
    valid item writes ``rem[pos] = fr``, ``shf[pos] = pos != fq``,
    ``con[pos] = fq == prev`` (``prev`` is ``last_fq`` for item 0) and
    ``occ[fq] = 1`` into the given planes; one whose position is past
    the last slot is dropped and still marks its bucket.  Positions must
    lie past every slot written before, as ``ops.build_span`` gives them.
    """
    for name, t in (("pos", pos), ("fq", fq), ("fr", fr), ("k", k),
                    ("last_fq", last_fq), ("rem", rem)):
        dispatch.require(t, name, torch.int32)
    for name, t in (("occ", occ), ("shf", shf), ("con", con)):
        dispatch.require(t, name, torch.bool)
    if not (pos.shape == fq.shape == fr.shape and pos.dim() == 1):
        raise ValueError("pos, fq and fr must share one 1-d shape")
    if not (k.dim() == 0 and last_fq.dim() == 0):
        raise ValueError("k and last_fq must be scalars")
    if not rem.shape == occ.shape == shf.shape == con.shape:
        raise ValueError("the four planes must share one shape")
    args = (pos, fq, fr, k, last_fq, rem, occ, shf, con)
    if not dispatch.use_kernel(*args):
        build_span_plain(*args)
        return
    P = cuda_lib.ptr
    err = _library().qf_build_span(
        P(pos), P(fq), P(fr), P(k), P(last_fq), pos.shape[0], rem.shape[0],
        P(rem), P(occ), P(shf), P(con), cuda_lib.stream_handle(pos.device),
    )
    cuda_lib.check(err, "qf_build_span")
    qf_build_span.launches += 1


qf_build_span.launches = 0
