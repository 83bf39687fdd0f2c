"""CUDA kernel: keys to quotient/remainder fingerprints in one launch.

Computes ``repro/core/fingerprint.py::fingerprint``, which is XLA code in
the JAX package, not a Pallas kernel: its wrappers jit the hash together
with each probe (``repro/kernels/ops.py``), so XLA fuses it.  The port's
plain version is ``core.fingerprint.fingerprint`` itself, which carries
every hash word in int64, masks it to 32 bits after each operation and
splits each product: about fifty launches a call, each writing the batch
and reading it back.  ``csrc/fingerprint.cu`` keeps both hash words in
registers and cuts the fingerprint out of the 64-bit word (hi:lo) with
one shift for every (q, r) the reference accepts.

The kernel path (``backend="pallas"``) takes int32 pairs for its probes,
which the probe kernels read as they are, and int64 pairs for its
inserts, the core's sort and ``pack`` contract (``fr`` the unsigned
value).

Bound on the card: bytes.  A key read (4 bytes, or 8 for int64 keys)
and two fingerprint words written.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from ..core import fingerprint as fpc
from . import cuda_lib, dispatch

KEY_DTYPES = (torch.int32, torch.uint32, torch.int64)
OUT_DTYPES = (torch.int32, torch.int64)

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p
_U32 = ctypes.c_uint32


def fingerprint_plain(keys, q: int, r: int, seed: int = 0, dtype=torch.int64):
    """Plain PyTorch version: the core's int64 chain, then ``dtype``
    (int32 keeps the remainder's low 32 bits, its uint32 bit pattern)."""
    fq, fr = fpc.fingerprint(keys, q, r, seed)
    return fq.to(dtype), fr.to(dtype)


@functools.cache
def _library():
    lib = cuda_lib.library("fingerprint")
    lib.fingerprint.argtypes = [_P, ctypes.c_int, _I64, _U32, _U32, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _P, _P, _P]
    lib.fingerprint.restype = ctypes.c_int
    return lib


def fingerprint(keys, q: int, r: int, seed: int = 0, dtype=torch.int64):
    """keys -> ``(quotient, remainder)`` of ``dtype``, as the core's
    ``fingerprint`` computes them.

    ``keys`` are int32, uint32 or int64 of any shape; a key is its low 32
    bits (an int32 key with the high bit set hashes as its uint32 value).
    ``dtype`` is int64 (the unsigned values) or int32 (the remainder's
    uint32 bit pattern).
    """
    with tracing.span("kernels.fingerprint"):
        if not 1 <= q <= 30:
            raise ValueError(f"q must be in [1, 30], got {q}")
        if not 1 <= r <= 32:
            raise ValueError(f"r must be in [1, 32], got {r}")
        if keys.dtype not in KEY_DTYPES:
            raise TypeError(f"keys must be one of {KEY_DTYPES}, got {keys.dtype}")
        if dtype not in OUT_DTYPES:
            raise TypeError(f"dtype must be one of {OUT_DTYPES}, got {dtype}")
        if not dispatch.use_kernel(keys):
            return fingerprint_plain(keys, q, r, seed, dtype)
        keys = keys.contiguous()
        fq = torch.empty(keys.shape, dtype=dtype, device=keys.device)
        fr = torch.empty_like(fq)
        s = seed & fpc.M32
        err = _library().fingerprint(
            keys.data_ptr(), keys.element_size(), keys.numel(),
            fpc._fmix32_int(s * 2 + 1), fpc._fmix32_int(s * 2 + 2), q, r,
            fq.element_size(), fq.data_ptr(), fr.data_ptr(),
            cuda_lib.stream_handle(keys.device),
        )
        cuda_lib.check(err, "fingerprint")
        fingerprint.launches += 1
        return fq, fr


fingerprint.launches = 0
