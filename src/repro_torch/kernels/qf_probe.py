"""CUDA kernel: bulk quotient-filter membership probe.

Replaces the TPU kernel ``repro/kernels/qf_probe.py::qf_probe_tiles``
(bodies ``_probe_kernel`` and ``window_decode``).  The TPU kernel sorted
queries by quotient, decoded one shared 2*wblk-slot window per tile by
(T x 2*wblk) broadcasts, and flagged queries whose cluster left the
window for an exact fallback.  ``csrc/qf_probe.cu`` gives each query
one thread that walks its cluster in global memory as the paper's
Fig. 3 does (``csrc/qf_walk.cuh``): step back to the cluster's start,
count the occupied buckets up to the quotient, step forward to that
run, compare remainders.  With no window there is nothing to overflow,
so no fallback, no ``ovf`` output and no host sync.

Bound on the card: bytes.  A query reads its int32 fingerprint pair (8
bytes) and the metadata bytes of its cluster, and writes one byte; the
gathers of neighbouring threads are not contiguous, so the kernel pays
whole 32-byte sectors for bytes it uses.  Clusters at the paper's load
are a few slots long, so a walk touches one or two sectors per plane.

The plain version is the exact decode-and-search lookup of
``core.quotient_filter``, not a copy of the walk, so the kernel is held
against an independent algorithm.  Both answers are defined for states
whose ``overflow`` flag is clear.
"""

from __future__ import annotations

import ctypes

import torch

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


def qf_probe(rem, occ, shf, con, fq, fr):
    """Membership of fingerprints ``(fq, fr)`` (int32, any order).

    Planes: ``rem`` int32 (uint32 bit pattern), ``occ``/``shf``/``con``
    bool.  ``fr`` holds the uint32 remainder bit pattern.  Returns
    ``present`` bool (B,).
    """
    require_planes(rem, occ, shf, con)
    for name, t in (("fq", fq), ("fr", fr)):
        dispatch.require(t, name, torch.int32)
    if fq.shape != fr.shape or fq.dim() != 1:
        raise ValueError("fq and fr must be one-dimensional and of one shape")
    if not dispatch.use_kernel(rem, occ, shf, con, fq, fr):
        return probe_plain(rem, occ, shf, con, fq, fr)
    present = torch.empty(fq.shape[0], dtype=torch.bool, device=fq.device)
    fn = cuda_lib.library("qf_probe").qf_probe
    fn.argtypes = [_P, _P, _P, _P, _I64, _P, _P, _I64, _P, _P]
    fn.restype = ctypes.c_int
    P = cuda_lib.ptr
    err = fn(
        P(rem), P(occ), P(shf), P(con), rem.shape[0], P(fq), P(fr),
        fq.shape[0], P(present), cuda_lib.stream_handle(fq.device),
    )
    cuda_lib.check(err, "qf_probe")
    qf_probe.launches += 1
    return present


qf_probe.launches = 0
