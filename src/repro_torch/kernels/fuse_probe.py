"""CUDA kernel: batched binary-fuse (3-gather) membership probe.

Replaces the TPU kernel ``repro/kernels/fuse_probe.py::fuse_probe_tiles``
(body ``_fuse_probe_kernel``).  The TPU kernel took queries sorted by
their first position, staged one scalar-prefetched 2*wblk-cell window
of the table per tile, gathered from it by one-hot contractions, and
flagged tiles whose positions outran the window, which its wrapper
settled with a ``lax.cond``.  ``csrc/fuse_probe.cu`` gives each query
one thread that reads its three cells directly: queries in any order,
no sort, no window, no overflow output and no host sync.

Bound on the card: bytes.  A query reads its three int32 positions and
its int32 fingerprint (16 bytes), gathers three int32 cells (12 bytes)
and writes one byte; each gather is a random 32-byte sector of a table
far larger than the L2 cache.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib, dispatch

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p


def fuse_probe_plain(table, p0, p1, p2, fp):
    """Plain PyTorch version: three gathers, xor, compare; bool (B,)."""
    got = table[p0.to(torch.int64)] ^ table[p1.to(torch.int64)]
    return (got ^ table[p2.to(torch.int64)]) == fp


def fuse_probe(table, p0, p1, p2, fp):
    """MAY-CONTAIN: bool (B,), ``table[p0] ^ table[p1] ^ table[p2] == fp``.

    ``table`` is int32 (slots,), the cells' bit pattern; ``p0``/``p1``/
    ``p2`` are int32 (B,) positions in ``[0, slots)`` in any order, and
    ``fp`` the int32 (B,) stored fingerprints.  The caller owns the
    empty-table guard (``n > 0``).
    """
    for t, name in ((table, "table"), (p0, "p0"), (p1, "p1"), (p2, "p2"), (fp, "fp")):
        dispatch.require(t, name, torch.int32)
    if table.dim() != 1 or p0.dim() != 1 or not (
        p0.shape == p1.shape == p2.shape == fp.shape
    ):
        raise ValueError("table must be (slots,) and p0/p1/p2/fp (B,) of one shape")
    if not dispatch.use_kernel(table, p0, p1, p2, fp):
        return fuse_probe_plain(table, p0, p1, p2, fp)
    hit = torch.empty(p0.shape[0], dtype=torch.bool, device=p0.device)
    fn = cuda_lib.library("fuse_probe").fuse_probe
    fn.argtypes = [_P, _I64, _P, _P, _P, _P, _I64, _P, _P]
    fn.restype = ctypes.c_int
    P = cuda_lib.ptr
    err = fn(
        P(table), table.shape[0], P(p0), P(p1), P(p2), P(fp), p0.shape[0],
        P(hit), cuda_lib.stream_handle(p0.device),
    )
    cuda_lib.check(err, "fuse_probe")
    fuse_probe.launches += 1
    return hit


fuse_probe.launches = 0
