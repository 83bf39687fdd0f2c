"""Bloom filter baseline (paper §2), bit for bit ``repro.core.bloom``.

Representation, as in the JAX package: one byte per bit (uint8 cells
holding 0 or 1), set by a scatter of ``max(cell, 1)``; space is
*accounted* in bits.  The counting Bloom filter uses the same uint8
array as counters that wrap (a delete adds 255), accounted at 4 bits
per counter.

PyTorch has no uint32 arithmetic on the CPU, so hash words are int64
holding the unsigned value (see :mod:`.fingerprint`); the double hash
``h1 + i*h2`` wraps to 32 bits before its modulo, as the uint32 sum
does.  Scatters that must drop an index go to a dump cell past the end,
which is cut off afterwards.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fingerprint import M32, fmix32
from . import quotient_filter as qf

__all__ = [
    "BloomConfig",
    "optimal_k",
    "empty",
    "insert",
    "lookup",
    "bit_indices",
    "counting_delete",
    "probes_until_reject",
    "first_zero_probes",
    "scatter_add",
    "scatter_max1",
]


class BloomConfig(NamedTuple):
    m_bits: int
    k: int
    seed: int = 0
    counting: bool = False

    @property
    def size_bytes(self) -> int:
        # modeled: 1 bit per cell (plain) / 4 bits per cell (counting)
        return (self.m_bits * (4 if self.counting else 1) + 7) // 8


def optimal_k(bits_per_element: float) -> int:
    """k = (m/n) ln 2, the paper's optimal hash count."""
    return max(1, round(bits_per_element * math.log(2)))


def empty(cfg: BloomConfig, device=None) -> torch.Tensor:
    return torch.zeros(cfg.m_bits, dtype=torch.uint8, device=qf.resolve_device(device))


def bit_indices(cfg: BloomConfig, keys: torch.Tensor) -> torch.Tensor:
    """(B, k) int32 bit positions by double hashing h1 + i*h2 (Kirsch-Mitzenmacher).

    A key is its low 32 bits.  ``i * h2`` stays below 2**37 for k <= 32,
    so the int64 sum is exact before it is wrapped to 32 bits.
    """
    k32 = keys.to(torch.int64) & M32
    h1 = fmix32(k32 ^ ((cfg.seed * 2 + 0x7F4A7C15) & M32))
    h2 = fmix32(k32 ^ ((cfg.seed * 2 + 0x94D049BB) & M32)) | 1
    i = torch.arange(cfg.k, dtype=torch.int64, device=keys.device)
    idx = ((h1[:, None] + i[None, :] * h2[:, None]) & M32) % cfg.m_bits
    return idx.to(torch.int32)


def scatter_max1(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cells.at[idx].max(1, mode="drop")``: a new plane, indices outside dropped.

    Every write of one cell carries the same value, so duplicates need
    no order.
    """
    n = cells.shape[0]
    out = torch.cat([cells, cells.new_zeros(1)])
    idx = torch.where((idx >= 0) & (idx < n), idx.to(torch.int64), n)
    out[idx] = out[idx].clamp(min=1)
    return out[:n]


def scatter_add(cells: torch.Tensor, idx: torch.Tensor, value: int) -> torch.Tensor:
    """``cells.at[idx].add(value, mode="drop")`` in the cells' own (wrapping) width."""
    n = cells.shape[0]
    out = torch.cat([cells, cells.new_zeros(1)])
    idx = torch.where((idx >= 0) & (idx < n), idx.to(torch.int64), n)
    add = torch.full(idx.shape, value, dtype=cells.dtype, device=cells.device)
    out.index_put_((idx,), add, accumulate=True)
    return out[:n]


def insert(cfg: BloomConfig, bits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    idx = bit_indices(cfg, keys).reshape(-1)
    if cfg.counting:
        return scatter_add(bits, idx, 1)
    return scatter_max1(bits, idx)


def counting_delete(cfg: BloomConfig, bits: torch.Tensor, keys: torch.Tensor):
    if not cfg.counting:
        raise ValueError("delete requires a counting Bloom filter")
    idx = bit_indices(cfg, keys).reshape(-1)
    return scatter_add(bits, idx, 255)  # wrapping -1


def lookup(cfg: BloomConfig, bits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """MAY-CONTAIN: AND of the k probed cells."""
    idx = bit_indices(cfg, keys)
    return (bits[idx.to(torch.int64)] != 0).all(1)


def probes_until_reject(cfg: BloomConfig, bits: torch.Tensor, keys: torch.Tensor):
    """Number of cells a short-circuiting lookup reads per key, and the indices.

    The paper's I/O analysis hinges on this: an absent key reads ~2
    cells in expectation, a present key reads all k.  Used by the
    EBF/BBF page accounting.
    """
    idx = bit_indices(cfg, keys)
    return first_zero_probes(bits[idx.to(torch.int64)] != 0), idx


def first_zero_probes(vals: torch.Tensor) -> torch.Tensor:
    """Per row of bool (B, k): position of the first False plus one, else k."""
    zero = ~vals
    first0 = zero.to(torch.uint8).argmax(1)  # the first maximum
    return torch.where(zero.any(1), first0 + 1, vals.shape[1])
