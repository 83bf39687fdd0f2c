"""CUDA kernel: batched binary-fuse (3-gather) membership probe, hash included.

Replaces the TPU kernel ``repro/kernels/fuse_probe.py::fuse_probe_tiles``
(body ``_fuse_probe_kernel``) and the ``fuse_hash`` its wrapper jitted
in front of it (``repro/kernels/ops.py``).  The TPU kernel took the
hashed positions sorted by the first, staged one scalar-prefetched
2*wblk-cell window of the table per tile, gathered from it by one-hot
contractions, and flagged tiles whose positions outran the window,
which its wrapper settled with a ``lax.cond``.  ``csrc/fuse_probe.cu``
gives each query one thread that takes its canonical fingerprint pair,
computes ``core.fuse_filter.fuse_hash`` in 32-bit registers (the
table's construction seed read on the card, so no host read), and reads
its three cells directly: queries in any order, no sort, no window, no
overflow output and no host sync.  Run eagerly, the same hash is about
two hundred int64 launches, each writing and reading back the batch.

Bound on the card: bytes, met as random 32-byte sectors.  A query reads
its int32 fingerprint pair (8 bytes), gathers three int32 cells (12
bytes) and writes one byte; each gather is a random sector of a table
far larger than the L2 cache.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from ..core import fuse_filter as ffc
from . import cuda_lib, dispatch

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p


def fuse_probe_plain(table, fq, fr, fuse_seed, segment_length, segment_count, fp_bits):
    """Plain PyTorch version: ``fuse_hash``, three gathers, xor, compare."""
    # fuse_hash reads the geometry alone; p and capacity play no part
    geometry = ffc.FuseConfig(
        p=0, fp_bits=fp_bits, segment_length=segment_length,
        segment_count=segment_count, capacity=0,
    )
    p0, p1, p2, fp = ffc.fuse_hash(geometry, fq, fr, fuse_seed)
    return (table[p0] ^ table[p1] ^ table[p2]).to(torch.int64) == fp


@functools.cache
def _library():
    lib = cuda_lib.library("fuse_probe")
    lib.fuse_probe.argtypes = [_P, _I64, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int,
                               _P, _P]
    lib.fuse_probe.restype = ctypes.c_int
    return lib


def fuse_probe(table, fq, fr, fuse_seed, segment_length, segment_count, fp_bits):
    """MAY-CONTAIN: bool (B,), ``table[p0] ^ table[p1] ^ table[p2] == fp``
    for ``(p0, p1, p2, fp) = fuse_hash(fq, fr, fuse_seed)``.

    ``table`` is int32 ``((segment_count + 2) * segment_length,)``, the
    cells' bit pattern; ``fq``/``fr`` are int32 (B,) canonical-split
    fingerprints in any order (``fr`` the uint32 bit pattern);
    ``fuse_seed`` is the table's construction seed, the state's int32 0-d
    tensor (read on the card) or a host int; ``segment_length``,
    ``segment_count`` and ``fp_bits`` are the ``FuseConfig``'s.  The
    caller owns the empty-table guard (``n > 0``).
    """
    for t, name in ((table, "table"), (fq, "fq"), (fr, "fr")):
        dispatch.require(t, name, torch.int32)
    if table.dim() != 1 or fq.dim() != 1 or fq.shape != fr.shape:
        raise ValueError("table must be (slots,) and fq/fr (B,) of one shape")
    L, C = segment_length, segment_count
    if L < 2 or L & (L - 1) or not 1 <= C < 1 << 15 or not 1 <= fp_bits <= 28:
        raise ValueError(
            "segment_length must be a power of two >= 2, segment_count in "
            f"[1, 2**15) and fp_bits in [1, 28], got {L}, {C}, {fp_bits}"
        )
    if table.shape[0] != (C + 2) * L:
        raise ValueError(f"table must hold (segment_count + 2) * segment_length = "
                         f"{(C + 2) * L} cells, got {table.shape[0]}")
    seed = fuse_seed if isinstance(fuse_seed, torch.Tensor) else None
    if seed is not None:
        dispatch.require(seed, "fuse_seed", torch.int32)
        if seed.dim() != 0:
            raise ValueError("fuse_seed must be a 0-d tensor or an int")
    if not dispatch.use_kernel(table, fq, fr, *([] if seed is None else [seed])):
        return fuse_probe_plain(table, fq, fr, fuse_seed, L, C, fp_bits)
    if seed is None:  # a fill on the card: no copy from the host
        s = operator.index(fuse_seed) & 0xFFFFFFFF
        seed = torch.full((), s - (s >> 31 << 32), dtype=torch.int32, device=fq.device)
    hit = torch.empty(fq.shape[0], dtype=torch.bool, device=fq.device)
    err = _library().fuse_probe(
        table.data_ptr(), table.shape[0], fq.data_ptr(), fr.data_ptr(),
        seed.data_ptr(), fq.shape[0], L, C, fp_bits, hit.data_ptr(),
        cuda_lib.stream_handle(fq.device),
    )
    cuda_lib.check(err, "fuse_probe")
    fuse_probe.launches += 1
    return hit


fuse_probe.launches = 0
