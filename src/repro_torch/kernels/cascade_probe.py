"""CUDA kernel: fused multi-level cascade membership probe.

Replaces the TPU kernel
``repro/kernels/cascade_probe.py::cascade_probe_tiles`` (body
``_make_kernel(L)``).  The TPU kernel ran one grid over canonically
sorted query tiles with a prefetched window per (tile, level), reading
each level's requotiented view of the queries.  ``csrc/cascade_probe.cu``
gives each query one thread that reads its canonical split once and
re-splits it for each level in registers; it writes the verdicts as bit
l of an int32 mask.  The L levels' plane pointers, count pointers, sizes
and remainder widths travel by value in the launch's parameter block.

Bound on the card: bytes, met as random 32-byte sectors.  A query reads
8 bytes and writes 4, and per live level an empty bucket costs one byte
(its ``occ`` bit), an occupied one the metadata of a cluster; the
function also reads the 4-byte count of every level.  A cascade holds
few live levels at a time (two of seven on the main path), so the
kernel reads the counts on the card, once per block, and a level whose
count is 0 answers 0 without a read of its planes; nothing is read to
the host.  Each thread issues the ``occ`` reads of all live levels
together, then runs the cluster walk of ``qf_probe``
(``csrc/qf_walk.cuh``) only where a bucket is occupied, so its chain of
dependent reads is one ``occ`` round plus the walks it needs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from ..core.fingerprint import M32
from . import cuda_lib, dispatch
from .qf_probe import probe_plain, require_planes

MAX_LEVELS = 32

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p


@functools.cache
def _library():
    """``csrc/cascade_probe.cu``'s library, its entry typed once."""
    lib = cuda_lib.library("cascade_probe")
    lib.cascade_probe.argtypes = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                  _P, _P, _I64, _P, _P]
    lib.cascade_probe.restype = ctypes.c_int
    return lib


def cascade_probe_plain(level_planes, level_n, level_r, fq, fr, r: int):
    """Plain PyTorch version: the exact lookup per level with ``n > 0``, as
    bitmasks; a level whose count is 0 answers 0, whatever its planes hold."""
    f = (fq.to(torch.int64) << r) | (fr.to(torch.int64) & M32)
    hit = torch.zeros(fq.shape[0], dtype=torch.int32, device=fq.device)
    for lvl, (planes, n, rl) in enumerate(zip(level_planes, level_n, level_r)):
        if not bool(n > 0):
            continue
        lq = (f >> rl).to(torch.int32)
        lr = (f & ((1 << rl) - 1)).to(torch.int32)
        hit = hit | (probe_plain(*planes, lq, lr).to(torch.int32) << lvl)
    return hit


def cascade_probe(level_planes, level_n, level_r, fq, fr, r: int):
    """Probe L quotient filters of one fingerprint width in one launch.

    ``level_planes`` is a sequence of ``(rem, occ, shf, con)`` plane
    tuples (any per-level size), ``level_n`` each level's count (the
    int32 0-d ``n`` of its state: a level whose count is 0 answers 0)
    and ``level_r`` each level's remainder width.  ``fq``/``fr`` are
    int32 (B,): the queries' fingerprints in one split with remainder
    width ``r`` (``fr`` the uint32 bit pattern); level l reads
    fingerprint ``f = fq << r | fr`` as ``(f >> r_l, f mod 2**r_l)``.
    Returns ``hit`` int32 (B,), bit l = level l.
    """
    with tracing.span("kernels.cascade_probe"):
        L = len(level_planes)
        if not 1 <= L <= MAX_LEVELS or len(level_r) != L or len(level_n) != L:
            raise ValueError(
                f"cascade_probe takes 1 to {MAX_LEVELS} levels and one count and "
                "one width each"
            )
        if not all(1 <= w <= 32 for w in (r, *level_r)):
            raise ValueError("remainder widths must be in [1, 32]")
        for planes in level_planes:
            require_planes(*planes)
        for n in level_n:
            dispatch.require(n, "level_n", torch.int32)
            if n.dim() != 0:
                raise ValueError("each level count must be a 0-d tensor")
        dispatch.require(fq, "fq", torch.int32)
        dispatch.require(fr, "fr", torch.int32)
        if fq.shape != fr.shape or fq.dim() != 1:
            raise ValueError("fq and fr must be one-dimensional and of one shape")
        planes_flat = (t for lv in level_planes for t in lv)
        if not dispatch.use_kernel(*planes_flat, *level_n, fq, fr):
            return cascade_probe_plain(level_planes, level_n, level_r, fq, fr, r)
        B = fq.shape[0]
        hit = torch.empty(B, dtype=torch.int32, device=fq.device)

        def table(ctype, values):
            return (ctype * L)(*values)

        rem_p, occ_p, shf_p, con_p = (
            table(_I64, (lv[k].data_ptr() for lv in level_planes)) for k in range(4)
        )
        counts = table(_I64, (n.data_ptr() for n in level_n))
        totals = table(_I64, (lv[0].shape[0] for lv in level_planes))
        widths = table(ctypes.c_int, level_r)
        P = cuda_lib.ptr
        err = _library().cascade_probe(
            rem_p, occ_p, shf_p, con_p, counts, totals, widths, L, r, P(fq), P(fr), B,
            P(hit), cuda_lib.stream_handle(fq.device),
        )
        cuda_lib.check(err, "cascade_probe")
        cascade_probe.launches += 1
        return hit


cascade_probe.launches = 0
