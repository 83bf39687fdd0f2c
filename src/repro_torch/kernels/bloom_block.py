"""CUDA kernels: the Bloom families' bulk count (insert/delete) and probe.

Replace the TPU kernels of ``repro/kernels/bloom_block.py``:

* ``bloom_count`` replaces ``bloom_count_tiles`` (body ``_count_kernel``).
  The TPU kernel sorted all k*B cell indices so that each S-cell output
  tile could prefetch one window of them and reduce a (2S x S) one-hot
  match into counts, flagging tiles denser than the window for a
  scatter recount.  ``csrc/bloom_count.cu`` zeroes the plane and gives
  each index one thread that adds one to its cell by an atomic: integer
  atomics commute, so the counts are exact in any order, with no sort
  and no ``fits`` output.  Bound: bytes, 4 per index read plus 4 per
  cell of the dense int32 plane written (the TPU contract's output).
* ``bloom_probe`` replaces ``bloom_probe_tiles`` (body
  ``_make_probe_kernel``).  The TPU kernel read bin-sorted queries from
  one prefetched 2*wblk-cell window per tile by one-hot gathers and
  flagged tiles whose bins outran it.  ``csrc/bloom_probe.cu`` gives
  each query one thread that reads its k cells directly, in the cells'
  own width (uint8 bits or int16 counters, no int32 copy): no sort, no
  window, no ``ovf``.  Bound: bytes, the query's int32 indices and
  cells up to its first empty cell and one byte out; the cells are
  random gathers, so the card moves a 32-byte sector for each, and
  its rate of random sectors bounds the kernel once enough gathers are
  in flight.  A thread reads its cells in groups of 2 (two
  independent cell loads, a ragged last group masked) and stops after
  the first group holding a zero: 6 dependent round trips for a member
  query at k = 12 instead of 12, for at most one cell read past the
  zero.  Wider groups read more sectors than the round trips they save
  are worth (``kernel_turns.py``; ``PERF.md``).

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (:mod:`.dispatch`); ``launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib, dispatch

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p

# the probe kernel's entry point for each cell type
_PROBE_FN = {torch.uint8: "bloom_probe_u8", torch.int16: "bloom_probe_i16"}


@functools.cache
def _count_library():
    """``csrc/bloom_count.cu``'s library, its entry typed once."""
    lib = cuda_lib.library("bloom_count")
    lib.bloom_count.argtypes = [_P, _I64, _I64, _P, _P]
    lib.bloom_count.restype = ctypes.c_int
    return lib


@functools.cache
def _probe_library():
    """``csrc/bloom_probe.cu``'s library, its entries typed once."""
    lib = cuda_lib.library("bloom_probe")
    for name in _PROBE_FN.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _I64, _P, _I64, ctypes.c_int, _P, _P]
        fn.restype = ctypes.c_int
    lib.bloom_probe_group.argtypes = []
    lib.bloom_probe_group.restype = ctypes.c_int
    return lib


def probe_group() -> int:
    """The cells a ``bloom_probe`` thread reads per round trip (the
    kernel's ``GROUP``), for counting the sectors a probe reads."""
    return _probe_library().bloom_probe_group()


def bloom_count_plain(idx_flat, ncells: int):
    """Plain PyTorch version: an accumulating scatter with a dump cell."""
    counts = torch.zeros(ncells + 1, dtype=torch.int32, device=idx_flat.device)
    cell = torch.where(
        (idx_flat >= 0) & (idx_flat < ncells), idx_flat.to(torch.int64), ncells
    )
    counts.index_put_((cell,), torch.ones_like(idx_flat), accumulate=True)
    return counts[:ncells]


def bloom_count(idx_flat, ncells: int):
    """Per-cell hit counts, int32 (ncells,), of int32 cell indices in any order.

    An index outside ``[0, ncells)`` (INT32_MAX for a masked key) counts
    nothing.
    """
    dispatch.require(idx_flat, "idx_flat", torch.int32)
    if idx_flat.dim() != 1:
        raise ValueError("idx_flat must be one-dimensional")
    if not 0 < ncells < 2**31:
        raise ValueError(f"ncells must lie in [1, 2**31), got {ncells}")
    if not dispatch.use_kernel(idx_flat):
        return bloom_count_plain(idx_flat, ncells)
    counts = torch.empty(ncells, dtype=torch.int32, device=idx_flat.device)
    err = _count_library().bloom_count(
        cuda_lib.ptr(idx_flat), idx_flat.shape[0], ncells, cuda_lib.ptr(counts),
        cuda_lib.stream_handle(idx_flat.device),
    )
    cuda_lib.check(err, "bloom_count")
    bloom_count.launches += 1
    return counts


bloom_count.launches = 0


def bloom_probe_plain(cells, idx):
    """Plain PyTorch version: a gather of the k cells, all non-zero."""
    return (cells[idx.to(torch.int64)] != 0).all(1)


def bloom_probe(cells, idx):
    """MAY-CONTAIN: bool (B,), the AND of ``cells[idx[b, j]] != 0`` over j.

    ``cells`` is uint8 (plain bits) or int16 (counting cells, the uint16
    bit pattern); ``idx`` is int32 (B, k) in any order, every index in
    ``[0, ncells)``.
    """
    if cells.dtype not in _PROBE_FN:
        raise TypeError(f"cells must be uint8 or int16, got {cells.dtype}")
    dispatch.require(cells, "cells", cells.dtype)
    dispatch.require(idx, "idx", torch.int32)
    if idx.dim() != 2 or cells.dim() != 1:
        raise ValueError("cells must be (ncells,) and idx (B, k)")
    if not dispatch.use_kernel(cells, idx):
        return bloom_probe_plain(cells, idx)
    hit = torch.empty(idx.shape[0], dtype=torch.bool, device=idx.device)
    err = getattr(_probe_library(), _PROBE_FN[cells.dtype])(
        cuda_lib.ptr(cells), cells.shape[0], cuda_lib.ptr(idx), idx.shape[0],
        idx.shape[1], cuda_lib.ptr(hit), cuda_lib.stream_handle(idx.device),
    )
    cuda_lib.check(err, "bloom_probe")
    bloom_probe.launches += 1
    return hit


bloom_probe.launches = 0
