"""SSD-oriented Bloom-filter variants used as baselines (paper §2).

The port of ``repro.core.bf_variants``:

* **EBF** — elevator Bloom filter: plain BF + RAM buffer of pending bit
  writes, flushed in sorted (elevator) page order when the buffer
  fills.  Lookups are immediate.
* **BBF** — buffered Bloom filter [Canim et al.]: *hash localization*
  (all k bits of one key land in a single erase-block-sized region)
  plus per-block sub-buffers flushed with one block write.
* **FBF** — forest-structured Bloom filter [Lu et al.]: an in-RAM BF
  first; once RAM fills it is sealed to disk and a forest of on-disk
  BFs grows; lookups probe every sealed layer.

Membership is computed exactly on the device; the **I/O schedule** each
policy would generate on the paper's SSD is counted in an
:class:`~repro_torch.core.cost_model.IOLog`, exactly as the JAX package
counts it.  The page counts are computed on the device too; each
operation reads back the few scalars the log needs.  Each structure
keeps its state on ``device``: the card unless given ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import bloom
from . import quotient_filter as qf
from .cost_model import IOLog
from .fingerprint import fmix32


def _unique_prefix_pages(pages: torch.Tensor, prefix: torch.Tensor) -> int:
    """Sum over rows of #unique values among the first prefix[i] entries."""
    k = pages.shape[1]
    cols = torch.arange(k, device=pages.device)
    live = cols[None, :] < prefix[:, None]  # (B, k)
    # dup[b, j]: pages[b, j] is among pages[b, :j]
    eq = pages[:, :, None] == pages[:, None, :]  # (B, k, k)
    seen_before = torch.ones(k, k, dtype=torch.bool, device=pages.device).tril(-1)
    dup = (eq & seen_before[None]).any(2)
    return int((live & ~dup).sum())


def _keys(keys, device) -> torch.Tensor:
    return torch.as_tensor(keys, device=device)


# ---------------------------------------------------------------------------
# EBF
# ---------------------------------------------------------------------------


@dataclass
class ElevatorBloomFilter:
    cfg: bloom.BloomConfig
    buffer_capacity_bits: int  # RAM budget in pending bit-writes
    io: IOLog = field(default_factory=IOLog)
    device: object = None

    def __post_init__(self):
        self.device = qf.resolve_device(self.device)
        self.bits = bloom.empty(self.cfg, self.device)
        self._pending: list[torch.Tensor] = []
        self._pending_count = 0
        self.page_bits = 4096 * 8

    def insert(self, keys) -> None:
        keys = _keys(keys, self.device)
        idx = bloom.bit_indices(self.cfg, keys).reshape(-1)
        self.bits = bloom.insert(self.cfg, self.bits, keys)  # logical state
        self._pending.append(idx)
        self._pending_count += idx.numel()
        if self._pending_count >= self.buffer_capacity_bits:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        allidx = torch.cat(self._pending)
        pages = torch.unique(allidx // self.page_bits)
        # elevator order: one sorted sweep; SSD still charges per-page writes
        self.io.rand_page_writes += int(pages.numel())
        self.io.flushes += 1
        self._pending = []
        self._pending_count = 0

    def lookup(self, keys) -> torch.Tensor:
        keys = _keys(keys, self.device)
        hit = bloom.lookup(self.cfg, self.bits, keys)
        probes, idx = bloom.probes_until_reject(self.cfg, self.bits, keys)
        self.io.rand_page_reads += _unique_prefix_pages(idx // self.page_bits, probes)
        return hit


# ---------------------------------------------------------------------------
# BBF
# ---------------------------------------------------------------------------


@dataclass
class BufferedBloomFilter:
    cfg: bloom.BloomConfig
    ram_bytes: int
    block_bytes: int = 256 * 1024  # erase block (paper's recommended setting)
    page_bytes: int = 4096
    io: IOLog = field(default_factory=IOLog)
    device: object = None

    def __post_init__(self):
        self.device = qf.resolve_device(self.device)
        self.block_bits = self.block_bytes * 8
        self.n_blocks = max(1, self.cfg.m_bits // self.block_bits)
        self.bits = bloom.empty(self.cfg, self.device)
        # per-block sub-buffers: equal division of RAM (paper §2)
        per_block_bytes = max(64, self.ram_bytes // self.n_blocks)
        self.subbuf_capacity = max(8, per_block_bytes // 4)  # 4B per pending op
        self._subbuf_counts = torch.zeros(
            self.n_blocks, dtype=torch.int64, device=self.device
        )

    def _localized_indices(self, keys: torch.Tensor):
        """Hash localization: block via h0, k bits inside the block.

        The block hash is ``fmix32(k ^ 0xB10C)`` with no seed, unlike the
        ``blocked_bloom`` family's ``seed * 2 + 0xB10C``.  Returns int64
        (B, k) bit positions and the (B,) blocks.
        """
        blk = fmix32((keys.to(torch.int64) & 0xFFFFFFFF) ^ 0xB10C) % self.n_blocks
        inner = bloom.bit_indices(self.cfg._replace(m_bits=self.block_bits), keys)
        return blk[:, None] * self.block_bits + inner, blk

    def insert(self, keys) -> None:
        keys = _keys(keys, self.device)
        idx, blk = self._localized_indices(keys)
        self.bits = bloom.scatter_max1(self.bits, idx.reshape(-1) % self.cfg.m_bits)
        self._subbuf_counts.index_add_(
            0, blk, torch.full_like(blk, self.cfg.k)
        )
        full = self._subbuf_counts >= self.subbuf_capacity
        n_full = int(full.sum())
        self.io.rand_page_writes += n_full
        self.io.seq_write_bytes += n_full * self.block_bytes
        self.io.flushes += n_full
        self._subbuf_counts.masked_fill_(full, 0)

    def lookup(self, keys) -> torch.Tensor:
        keys = _keys(keys, self.device)
        idx, _ = self._localized_indices(keys)
        vals = self.bits[idx % self.cfg.m_bits] != 0
        hit = vals.all(1)
        # short-circuit probes; bits localized to one block but spread
        # across its 4 KiB read pages (sorted probe order, OS prefetch
        # per the paper — still distinct page reads)
        probes = bloom.first_zero_probes(vals)
        pages = idx // (self.page_bytes * 8)
        self.io.rand_page_reads += _unique_prefix_pages(pages, probes)
        return hit


# ---------------------------------------------------------------------------
# FBF
# ---------------------------------------------------------------------------


@dataclass
class ForestBloomFilter:
    bits_per_element: float
    ram_bytes: int
    total_elements: int  # sizing hint for the on-disk layers
    seed: int = 0
    block_bytes: int = 256 * 1024
    page_bytes: int = 4096
    io: IOLog = field(default_factory=IOLog)
    device: object = None

    def __post_init__(self):
        self.device = qf.resolve_device(self.device)
        k = bloom.optimal_k(self.bits_per_element)
        ram_bits = self.ram_bytes * 8
        self.ram_cfg = bloom.BloomConfig(m_bits=ram_bits, k=k, seed=self.seed)
        self.ram_bits_arr = bloom.empty(self.ram_cfg, self.device)
        self.ram_count = 0
        self.ram_capacity = int(ram_bits / self.bits_per_element)
        self.layers: list[tuple[bloom.BloomConfig, torch.Tensor]] = []
        self._layer_seed = self.seed + 1
        self._active_subbuf = 0
        self.subbuf_capacity = max(8, (self.ram_bytes // 8) // 4)

    def _seal_ram(self) -> None:
        """RAM BF is full: write it to disk as a new forest layer."""
        self.layers.append((self.ram_cfg, self.ram_bits_arr))
        self.io.seq_write_bytes += self.ram_cfg.m_bits // 8
        self.io.flushes += 1
        self._layer_seed += 1
        self.ram_cfg = self.ram_cfg._replace(seed=self._layer_seed)
        self.ram_bits_arr = bloom.empty(self.ram_cfg, self.device)
        self.ram_count = 0

    def insert(self, keys) -> None:
        keys = _keys(keys, self.device)
        n = int(keys.shape[0])
        self.ram_bits_arr = bloom.insert(self.ram_cfg, self.ram_bits_arr, keys)
        self.ram_count += n
        if len(self.layers) > 0:
            # post-spill phase: inserts also cost buffered block writes
            # (space stealing delays them; amortized accounting)
            self._active_subbuf += n * self.ram_cfg.k
            while self._active_subbuf >= self.subbuf_capacity:
                self.io.rand_page_writes += 1
                self.io.seq_write_bytes += self.block_bytes
                self._active_subbuf -= self.subbuf_capacity
        if self.ram_count >= self.ram_capacity:
            self._seal_ram()

    def lookup(self, keys) -> torch.Tensor:
        keys = _keys(keys, self.device)
        out = bloom.lookup(self.ram_cfg, self.ram_bits_arr, keys)
        pending = ~out
        # layers in the order they were sealed, as the read counts assume
        for cfg, arr in self.layers:
            if not bool(pending.any()):
                break
            sub = torch.nonzero(pending)[:, 0]
            lhit = bloom.lookup(cfg, arr, keys[sub])
            # block localization => ~1 page read per probed layer
            self.io.rand_page_reads += int(sub.numel())
            out[sub[lhit]] = True
            pending[sub[lhit]] = False
        return out
