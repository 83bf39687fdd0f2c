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
"""

from __future__ import annotations

import ctypes

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
    fn = cuda_lib.library("qf_build").qf_build_planes
    fn.argtypes = [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    P = cuda_lib.ptr
    err = fn(
        P(pos), P(fq), P(fr), P(n), pos.shape[0], total_slots,
        P(rem), P(occ), P(shf), P(con), cuda_lib.stream_handle(dev),
    )
    cuda_lib.check(err, "qf_build_planes")
    qf_build_planes.launches += 1
    return rem, occ, shf, con


qf_build_planes.launches = 0
