"""Vectorized fingerprinting, bit for bit the hash of ``repro.core.fingerprint``.

The paper hashes every key to a p-bit fingerprint f, split as
``f_q = f >> r`` (quotient) and ``f_r = f mod 2**r`` (remainder).  The
64-bit hash is two 32-bit murmur3 ``fmix32`` words (hi, lo); the
fingerprint is the top p = q + r bits of (hi:lo), so quotient and
remainder stay consistent across any (q, r) split of the same p.

PyTorch has no shifts or adds for ``uint32`` on the CPU, so every hash
word is carried in ``int64`` holding the unsigned value and masked to
32 bits after each operation.  Products go through :func:`_mul32`,
which splits the constant so no ``int64`` product overflows.
"""

from __future__ import annotations

import torch

__all__ = [
    "fmix32",
    "hash2",
    "fingerprint",
    "extract_bits",
    "fold_bytes",
]

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and constant ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 words holding uint32 values."""
    x = x.to(torch.int64) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _fmix32_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash2(keys: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit hash words (hi, lo) per key, as int64.

    A key is its low 32 bits, as ``astype(uint32)`` makes it in the JAX
    package.
    """
    k = keys.to(torch.int64) & M32
    s = seed & M32
    hi = fmix32(k ^ _fmix32_int(s * 2 + 1))
    lo = fmix32(((k + _GOLDEN) & M32) ^ _fmix32_int(s * 2 + 2))
    return hi, lo


def _mask(width: int) -> int:
    return M32 if width >= 32 else (1 << width) - 1


def extract_bits(hi: torch.Tensor, lo: torch.Tensor, start: int, width: int):
    """Bits [start, start+width) of the 64-bit word (hi:lo), MSB-first."""
    if not (0 < width <= 32 and 0 <= start and start + width <= 64):
        raise ValueError(f"bad bit slice start={start} width={width}")
    end = start + width
    if end <= 32:
        return (hi >> (32 - end)) & _mask(width)
    if start >= 32:
        return (lo >> (64 - end)) & _mask(width)
    lo_bits = end - 32
    hipart = hi & _mask(32 - start)
    return ((hipart << lo_bits) | (lo >> (32 - lo_bits))) & _mask(width)


def fingerprint(keys: torch.Tensor, q: int, r: int, seed: int = 0):
    """keys -> (quotient, remainder), both int64 (B,).

    quotient = top q bits of the 64-bit hash, remainder = the next r bits
    (an unsigned value below ``2**r``).
    """
    if not (1 <= q <= 30):
        raise ValueError(f"q must be in [1, 30], got {q}")
    if not (1 <= r <= 32):
        raise ValueError(f"r must be in [1, 32], got {r}")
    hi, lo = hash2(keys, seed)
    return extract_bits(hi, lo, 0, q), extract_bits(hi, lo, q, r)


def fold_bytes(data: bytes, seed: int = 0) -> int:
    """Host-side FNV-1a fold of arbitrary bytes to a 32-bit key."""
    h = (0x811C9DC5 ^ seed) & M32
    for b in data:
        h ^= b
        h = (h * 0x01000193) & M32
    return h
