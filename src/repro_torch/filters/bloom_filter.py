"""Bloom-filter families under the functional protocol (paper §2).

The port of ``repro.filters.bloom_filter``:

* ``bloom`` — classic k-hash Bloom filter (double hashing).  With
  ``counting=True`` the cells are counters, enabling ``delete`` and
  exact ``merge`` (counter addition); the plain variant merges by
  bitwise OR and has no ``delete``.
* ``blocked_bloom`` — hash-localized variant: all k probes of a key
  land in one ``block_bits``-sized region (one flash page), the in-RAM
  analogue of the paper's buffered Bloom filter [Canim et al.].

The state is a :class:`BloomState`: the cell plane and an int32 insert
count.  Plain cells are uint8 holding 0 or 1.  Counting cells are uint16
in the JAX package; PyTorch on the CPU has no uint16 arithmetic, so here
they are ``torch.int16`` holding the uint16 bit pattern: sums and
differences are taken in int32 and narrowed, which wraps as uint16 does,
membership tests ``!= 0``, and the fold's saturation reads the unsigned
value.  ``to_numpy`` returns the cells as uint16.

Backends: ``"reference"`` is the JAX package's scatter path;
``"pallas"`` runs the port's kernel path for both families
(:mod:`repro_torch.kernels.bloom_block`: insert and delete through the
count kernel, ``contains`` through the probe kernel; their plain
versions for state on the CPU).  The JAX package pins the classic
``bloom`` to its XLA lowering because its table-wide gathers do not fit
a TPU window; the CUDA kernels have no window, and the answers are the
same either way.

Cell indices are int32, as in the JAX package, whose blocked index
``blk * block_bits + inner`` wraps at 2**31 cells: ``make`` and ``grow``
refuse a plane of 2**31 cells or more.

Growth tiles the cell plane (``h mod 2m`` is ``h mod m`` or that plus
``m``), which keeps every stored key; shrink folds the two halves back
by OR (plain) or saturating addition (counting).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import bloom
from ..core.fingerprint import M32, fmix32
from ..core import quotient_filter as qf
from ..kernels import ops as kops
from .qf_filter import valid_mask
from .registry import FilterImpl, register

BACKENDS = ("reference", "pallas")
MAX_CELLS = 2**31  # int32 cell indices


class BloomFilterConfig(NamedTuple):
    m_bits: int
    k: int
    seed: int = 0
    counting: bool = False
    shrink_load: float = 0.4  # low watermark vs the folded (halved) tiling
    backend: str = "reference"  # "pallas" routes through kernels.ops

    @property
    def core(self) -> bloom.BloomConfig:
        return bloom.BloomConfig(
            m_bits=self.m_bits, k=self.k, seed=self.seed, counting=self.counting
        )


class BlockedBloomConfig(NamedTuple):
    m_bits: int
    k: int
    block_bits: int = 4096 * 8  # one 4 KiB page per key
    seed: int = 0
    counting: bool = False
    shrink_load: float = 0.4  # low watermark vs the folded (halved) tiling
    backend: str = "reference"  # "pallas" routes through kernels.ops

    @property
    def n_blocks(self) -> int:
        return max(1, self.m_bits // self.block_bits)

    @property
    def size_bytes(self) -> int:
        cells = self.n_blocks * self.block_bits
        return (cells * (4 if self.counting else 1) + 7) // 8


class BloomState(NamedTuple):
    cells: torch.Tensor  # uint8 bits / int16 counting cells (uint16 bit pattern)
    n: torch.Tensor  # int32 scalar, number of (valid) keys inserted


def _indices(cfg, keys: torch.Tensor) -> torch.Tensor:
    """(B, k) int32 cell indices for either config flavor."""
    if isinstance(cfg, BloomFilterConfig):
        return bloom.bit_indices(cfg.core, keys)
    # blocked: block via an independent hash, k cells inside the block
    k32 = keys.to(torch.int64) & M32
    blk = fmix32(k32 ^ ((cfg.seed * 2 + 0xB10C) & M32)) % cfg.n_blocks
    inner = bloom.bit_indices(
        bloom.BloomConfig(m_bits=cfg.block_bits, k=cfg.k, seed=cfg.seed), keys
    )
    return (blk[:, None] * cfg.block_bits + inner).to(torch.int32)


def _cells(cfg) -> int:
    if isinstance(cfg, BloomFilterConfig):
        return cfg.m_bits
    return cfg.n_blocks * cfg.block_bits


def _count(keys, k) -> torch.Tensor:
    """The batch's key count, an int32 scalar on the keys' device."""
    return qf._i32(keys.shape[0] if k is None else k, keys.device)


def _masked(idx: torch.Tensor, keys, k) -> torch.Tensor:
    """Route cells of invalid (padding) keys to an out-of-range index."""
    if k is None:
        return idx
    return torch.where(valid_mask(keys, k)[:, None], idx, qf.INT32_MAX)


def _cell_dtype(cfg):
    return torch.int16 if cfg.counting else torch.uint8


def _capacity(cfg) -> int:
    """Design capacity: n = m ln2 / k keeps the fp rate near 2^-k."""
    return max(1, int(_cells(cfg) * math.log(2) / cfg.k))


def _check(cfg) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {cfg.backend!r}")
    if _cells(cfg) >= MAX_CELLS:
        raise ValueError(
            f"{_cells(cfg)} cells: int32 cell indices need fewer than 2**31"
        )


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 values to the int16 bit pattern of their value mod 2**16."""
    return x.to(torch.int16)


def make_impl(cfg_cls, name: str, paper_section: str):
    def make(device=None, **spec):
        cfg = cfg_cls(**spec)
        _check(cfg)
        device = qf.resolve_device(device)
        return cfg, BloomState(
            cells=torch.zeros(_cells(cfg), dtype=_cell_dtype(cfg), device=device),
            n=torch.zeros((), dtype=torch.int32, device=device),
        )

    def _counts(cfg, keys, k):
        """Per-cell hit counts of a masked batch via the count kernel."""
        idx = _masked(_indices(cfg, keys), keys, k).reshape(-1)
        return kops.bloom_counts(idx, _cells(cfg))

    def insert(cfg, state, keys, k=None):
        if cfg.backend == "pallas":
            counts = _counts(cfg, keys, k)
            if cfg.counting:
                cells = _wrap16(counts.add_(state.cells))
            else:
                cells = torch.maximum(state.cells, (counts > 0).view(torch.uint8))
            return BloomState(cells=cells, n=state.n + _count(keys, k))
        idx = _masked(_indices(cfg, keys), keys, k).reshape(-1)
        if cfg.counting:
            cells = bloom.scatter_add(state.cells, idx, 1)
        else:
            cells = bloom.scatter_max1(state.cells, idx)
        return BloomState(cells=cells, n=state.n + _count(keys, k))

    def contains(cfg, state, keys):
        idx = _indices(cfg, keys)
        if cfg.backend == "pallas":
            return kops.bloom_probe(state.cells, idx)
        return (state.cells[idx.to(torch.int64)] != 0).all(1)

    def delete(cfg, state, keys, k=None):
        if not cfg.counting:
            raise NotImplementedError(
                f"{name}: delete requires counting=True (plain bits can't unset)"
            )
        if cfg.backend == "pallas":
            counts = _counts(cfg, keys, k)
            # wrapping subtract == the reference's per-copy add(0xFFFF)
            cells = _wrap16(counts.neg_().add_(state.cells))
            return BloomState(cells=cells, n=state.n - _count(keys, k))
        idx = _masked(_indices(cfg, keys), keys, k).reshape(-1)
        cells = bloom.scatter_add(state.cells, idx, -1)  # wrapping -1
        return BloomState(cells=cells, n=state.n - _count(keys, k))

    def merge(cfg, sa, sb):
        if cfg.counting:
            cells = _wrap16(sa.cells.to(torch.int32) + sb.cells)
        else:
            cells = torch.maximum(sa.cells, sb.cells)
        return BloomState(cells=cells, n=sa.n + sb.n)

    def needs_resize(cfg, state):
        return state.n >= _capacity(cfg)

    def grow(cfg, state):
        """Double the cell plane by tiling it (membership-exact, see the
        module docstring); the config's cell count doubles to match."""
        if isinstance(cfg, BloomFilterConfig):
            new_cfg = cfg._replace(m_bits=2 * cfg.m_bits)
        else:
            # pin m_bits to the exact cell count so n_blocks doubles even
            # when the original m_bits was not a multiple of block_bits
            new_cfg = cfg._replace(m_bits=2 * cfg.n_blocks * cfg.block_bits)
        _check(new_cfg)
        return new_cfg, state._replace(cells=torch.cat([state.cells, state.cells]))

    def resize(cfg, state, factor: int = 2):
        """Grow by a power-of-two factor (shrinking would lose keys)."""
        if factor < 1 or factor & (factor - 1):
            raise ValueError("bloom resize factor must be a power of two >= 1")
        while factor > 1:
            cfg, state = grow(cfg, state)
            factor //= 2
        return cfg, state

    def _can_fold(cfg) -> bool:
        # folding halves the tiling: need an even cell count and a
        # remaining array the hash arithmetic can still index
        cells = _cells(cfg)
        if isinstance(cfg, BlockedBloomConfig):
            return cfg.n_blocks >= 2 and cfg.n_blocks % 2 == 0
        return cells % 2 == 0 and cells // 2 >= max(64, cfg.k)

    def needs_shrink(cfg, state):
        if not _can_fold(cfg):
            return torch.zeros((), dtype=torch.bool, device=state.n.device)
        half_capacity = max(1, int(_cells(cfg) // 2 * math.log(2) / cfg.k))
        return state.n <= int(cfg.shrink_load * half_capacity)

    def shrink(cfg, state):
        """Halve the cell plane by folding the two tiles together — the
        exact inverse of ``grow``'s tiling: OR-ing (or adding, saturated,
        for counting cells) the halves keeps every stored key."""
        if not _can_fold(cfg):
            raise ValueError(f"{name}: cell tiling cannot fold below this size")
        half = _cells(cfg) // 2
        lo, hi = state.cells[:half], state.cells[half:]
        if cfg.counting:
            u16 = lambda x: x.to(torch.int32) & 0xFFFF  # the unsigned value
            folded = _wrap16(torch.clamp(u16(lo) + u16(hi), max=0xFFFF))
        else:
            folded = torch.maximum(lo, hi)
        if isinstance(cfg, BloomFilterConfig):
            new_cfg = cfg._replace(m_bits=half)
        else:
            new_cfg = cfg._replace(m_bits=(cfg.n_blocks // 2) * cfg.block_bits)
        return new_cfg, state._replace(cells=folded)

    def stats(cfg, state):
        set_ = state.cells != 0
        # the JAX package's float32 mean: the sum times the float32
        # reciprocal of the count (a true division can round one ulp away)
        one = torch.ones((), dtype=torch.float32, device=set_.device)
        return {
            "n": state.n,
            "cells_set": set_.sum(dtype=torch.int32),
            "fill": set_.sum(dtype=torch.float32) * (one / set_.numel()),
            "load": state.n.to(torch.float32) / _capacity(cfg),
            "size_bytes": cfg.size_bytes
            if hasattr(cfg, "size_bytes")
            else cfg.core.size_bytes,
        }

    return register(
        FilterImpl(
            name=name,
            paper_section=paper_section,
            cfg_cls=cfg_cls,
            make=make,
            insert=insert,
            contains=contains,
            stats=stats,
            delete=delete,
            merge=merge,
            needs_resize=needs_resize,
            grow=grow,
            resize=resize,
            needs_shrink=needs_shrink,
            shrink=shrink,
            can_delete=lambda cfg: cfg.counting,  # plain bits can't unset
        )
    )


BLOOM = make_impl(
    BloomFilterConfig, "bloom", "§2 (Bloom filter baseline; counting variant [3])"
)
BLOCKED_BLOOM = make_impl(
    BlockedBloomConfig,
    "blocked_bloom",
    "§2 (hash localization — buffered Bloom filter, Canim et al.)",
)
