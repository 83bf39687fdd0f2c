"""CUDA kernel: decode the slot planes into the sorted fingerprint streams.

Computes ``repro/core/quotient_filter.py::extract``, which is XLA code in
the JAX package, not a Pallas kernel: three cumsums, a ``searchsorted``
and two scatters.  The port's plain version is that arithmetic as the
core has it, ``quotient_filter.decode_planes``: at q = 29 it makes slot-long
int32 and int64 temporaries, each several GB, and a binary search of a
slot-long cumsum per slot.  Every kernel-path insert, merge, delete and
resize decodes the whole table it rebuilds.

``csrc/qf_decode.cu`` streams the planes in two launches: an index pass
over ``occ``/``shf``/``con`` that carries the occupied buckets, runs and
nonempty slots across tiles by a decoupled look-back (the status words
of ``csrc/qf_scan.cuh``, three a tile, in a scratch zeroed for the call)
and compacts the
occupied buckets' positions, then a write pass in which each warp decodes
a 1024-slot chunk and stores its rows whole.  Bound on the card: bytes,
7 plane bytes read and 16 stream bytes written a slot; the compacted
positions add 4 bytes written and read an occupied bucket.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from ..core import quotient_filter as qf
from . import cuda_lib, dispatch

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p

DECODE_TILE = 8192  # slots a block of the index pass takes: csrc/qf_decode.cu's DECODE_TILE
DECODE_CHUNK = 1024  # slots a warp of the write pass takes: its DECODE_CHUNK
DECODE_WORD = 32  # slots a bit word holds: its DECODE_LANE_SLOTS

# the plain version for CPU state: the core's decode, bound when this loads
decode_plain = qf.decode_planes


@functools.cache
def _library():
    lib = cuda_lib.library("qf_decode")
    lib.qf_decode.argtypes = [_P] * 4 + [_I64] + [_P] * 10
    lib.qf_decode.restype = ctypes.c_int
    return lib


def qf_decode(rem, occ, shf, con):
    """The sorted fingerprints held by the planes: ``(fq, fr)``, int64
    (total_slots,), a row for each nonempty slot and then
    ``(INT32_MAX, UINT32_MAX)`` rows; equal to
    ``quotient_filter.decode_planes`` for any planes.  ``rem`` is int32 (the uint32 bit pattern), the other
    planes bool; on the card the three bool planes are read 16 bytes at a
    time, so they must be 16-byte aligned, as a fresh allocation is (the
    launch raises otherwise).  Nothing is read on the host."""
    with tracing.span("kernels.qf_decode"):
        dispatch.require(rem, "rem", torch.int32)
        for name, p in (("occ", occ), ("shf", shf), ("con", con)):
            dispatch.require(p, name, torch.bool)
        if rem.dim() != 1 or not rem.shape == occ.shape == shf.shape == con.shape:
            raise ValueError("the four planes must share one 1-d shape")
        if not dispatch.use_kernel(rem, occ, shf, con):
            return decode_plain(rem, occ, shf, con)
        t = rem.shape[0]
        if t > qf.INT32_MAX:
            raise ValueError("the decode takes fewer than 2**31 slots")
        dev = rem.device
        chunks, words = -(-t // DECODE_CHUNK), -(-t // DECODE_WORD)
        work = torch.empty(t + 2 * chunks + 2 * words + 2, dtype=torch.int32, device=dev)
        parts = work.split([t, chunks, chunks, words, words, 2])
        fq = torch.empty(t, dtype=torch.int64, device=dev)
        fr = torch.empty_like(fq)
        # the look-back's ticket and three status words a tile, zeroed for
        # each call rather than kept, so that none of it stays allocated
        scratch = torch.zeros(1 + 3 * -(-t // DECODE_TILE), dtype=torch.int64, device=dev)
        P = cuda_lib.ptr
        err = _library().qf_decode(
            P(rem), P(occ), P(shf), P(con), t, P(scratch), *map(P, parts),
            P(fq), P(fr), cuda_lib.stream_handle(dev),
        )
        cuda_lib.check(err, "qf_decode")
        qf_decode.launches += 1
        return fq, fr


qf_decode.launches = 0
