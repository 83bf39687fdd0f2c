"""CUDA kernel: bulk quotient-filter membership probe.

Replaces the TPU kernel ``repro/kernels/qf_probe.py::qf_probe_tiles``
(bodies ``_probe_kernel`` and ``window_decode``) and the quotient sort
its wrapper ran around it (``repro/kernels/ops.py``).  The TPU kernel
decoded one shared 2*wblk-slot window per tile of sorted queries by
(T x 2*wblk) broadcasts, and flagged queries whose cluster left the
window for an exact fallback.  ``csrc/qf_probe.cu`` walks each query's
whole cluster as the paper's Fig. 3 does: step back to the cluster's
start, count the occupied buckets up to the quotient, step forward to
that run, compare remainders.  With no window limit there is nothing to
overflow, so no fallback, no ``ovf`` output and no host sync.

Bound on the card: bytes, met as random 32-byte sectors.  A query
reads its int32 fingerprint pair (8 bytes) and the metadata bytes of
its cluster, and writes one byte; every metadata byte a walk reads
costs a sector.  So a dense probe (``DENSE``) first packs ``occ``,
``shf`` and ``con`` into bit planes small enough to stay in L2
(``pack_bits``: 6.3 MB at q = 24, one pass over the byte planes), and
the walks run there on whole 32-slot words (``walk``); only the
remainders they compare come from ``rem``.  A sparse probe walks the
byte planes directly: there the pack would read more than the walks.
Putting the queries in quotient order first, as the TPU wrapper did,
was measured and lost (``kernel_turns.py``): it cost more than the
walks saved.

The plain version is the exact decode-and-search lookup of
``core.quotient_filter``, not a copy of the walk, so the kernel is held
against an independent algorithm.  Both answers are defined for states
whose ``overflow`` flag is clear.
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


def probe_plain(rem, occ, shf, con, fq, fr):
    """Plain PyTorch version of the kernel: ``present`` bool (B,)."""
    return qf.lookup_planes(rem, occ, shf, con, fq, fr)


def require_planes(rem, occ, shf, con) -> None:
    dispatch.require(rem, "rem", torch.int32)
    for name, t in (("occ", occ), ("shf", shf), ("con", con)):
        dispatch.require(t, name, torch.bool)
        if t.shape != rem.shape:
            raise ValueError(f"{name} must have the shape of rem")


DENSE = 32  # pack the bit planes when queries * DENSE >= slots


@functools.cache
def _library():
    """``csrc/qf_probe.cu``'s library, its entry points typed once: a
    façade probe is host-bound, so the wrapper's own time counts."""
    lib = cuda_lib.library("qf_probe")
    lib.qf_probe_pack.argtypes = [_P, _P, _P, _I64, _P, _P]
    lib.qf_probe.argtypes = [_P, _P, _P, _P, _I64, _P, _P, _I64, _P, _P, ctypes.c_int, _P]
    lib.qf_probe_pack.restype = lib.qf_probe.restype = ctypes.c_int
    return lib


def pack_bits(occ, shf, con):
    """The card's bit planes of ``occ``, ``shf`` and ``con``: int32
    ``(3 * ceil(slots / 32),)``, word w of each holding slots
    ``[32 w, 32 w + 32)``, bit j slot ``32 w + j``."""
    t = occ.shape[0]
    bits = torch.empty(3 * ((t + 31) // 32), dtype=torch.int32, device=occ.device)
    err = _library().qf_probe_pack(
        occ.data_ptr(), shf.data_ptr(), con.data_ptr(), t, bits.data_ptr(),
        cuda_lib.stream_handle(occ.device),
    )
    cuda_lib.check(err, "qf_probe (pack)")
    return bits


def walk(rem, occ, shf, con, fq, fr, bits=None, pack=False):
    """The card's cluster walks: over the bit planes ``bits`` where given
    (packed from these planes first when ``pack``, else ``pack_bits`` of
    them), else over the byte planes."""
    present = torch.empty(fq.shape[0], dtype=torch.bool, device=fq.device)
    err = _library().qf_probe(
        rem.data_ptr(), occ.data_ptr(), shf.data_ptr(), con.data_ptr(),
        rem.shape[0], fq.data_ptr(), fr.data_ptr(), fq.shape[0],
        present.data_ptr(), None if bits is None else bits.data_ptr(), pack,
        cuda_lib.stream_handle(fq.device),
    )
    cuda_lib.check(err, "qf_probe")
    return present


def qf_probe(rem, occ, shf, con, fq, fr):
    """Membership of fingerprints ``(fq, fr)`` (int32, any order).

    Planes: ``rem`` int32 (uint32 bit pattern), ``occ``/``shf``/``con``
    bool.  ``fr`` holds the uint32 remainder bit pattern.  Returns
    ``present`` bool (B,).
    """
    with tracing.span("kernels.qf_probe"):
        require_planes(rem, occ, shf, con)
        for name, t in (("fq", fq), ("fr", fr)):
            dispatch.require(t, name, torch.int32)
        if fq.shape != fr.shape or fq.dim() != 1:
            raise ValueError("fq and fr must be one-dimensional and of one shape")
        if not dispatch.use_kernel(rem, occ, shf, con, fq, fr):
            return probe_plain(rem, occ, shf, con, fq, fr)
        t = rem.shape[0]
        bits = None
        if fq.shape[0] * DENSE >= t:
            bits = torch.empty(3 * ((t + 31) // 32), dtype=torch.int32, device=fq.device)
        present = walk(rem, occ, shf, con, fq, fr, bits, pack=True)
        qf_probe.launches += 1
        return present


qf_probe.launches = 0
