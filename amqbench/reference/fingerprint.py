"""The fingerprint hash, a frozen copy in plain PyTorch.

A key is its low 32 bits.  It hashes to two 32-bit murmur3 ``fmix32``
words (hi, lo), and a p-bit fingerprint is the top p bits of the 64-bit
word (hi:lo).  A quotient filter with q + r = p takes the top q bits as
the bucket and the next r bits as the remainder, so one p-bit value
serves every (q, r) split of p.

Every word is carried in int64 holding the unsigned value and masked to
32 bits after each operation; products split the constant so that no
int64 product overflows.  The keys are hashed in chunks, so that a
batch of hundreds of millions of keys needs a bounded working set.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
CHUNK = 1 << 25


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fmix32_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _chunk(keys: torch.Tensor, p: int, seed: int) -> torch.Tensor:
    k = keys.to(torch.int64) & M32
    s = seed & M32
    hi = fmix32(k ^ fmix32_int(2 * s + 1))
    lo = fmix32(((k + GOLDEN) & M32) ^ fmix32_int(2 * s + 2))
    if p <= 32:
        return hi >> (32 - p)
    return (hi << (p - 32)) | (lo >> (64 - p))


def fingerprints(keys: torch.Tensor, p: int, seed: int = 0) -> torch.Tensor:
    """The p-bit fingerprints of ``keys`` (any integer dtype), int64."""
    if not 1 <= p <= 62:
        raise ValueError(f"fingerprint bits p must be in [1, 62], got {p}")
    keys = keys.reshape(-1)
    out = torch.empty(keys.shape[0], dtype=torch.int64, device=keys.device)
    for s in range(0, keys.shape[0], CHUNK):
        out[s : s + CHUNK] = _chunk(keys[s : s + CHUNK], p, seed)
    return out
