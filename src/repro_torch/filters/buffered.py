"""Buffered quotient filter, functional (paper §4's RAM+flash QF).

The port of ``repro.filters.buffered``.  One small RAM QF absorbs
inserts; when it crosses ``max_load`` the whole RAM QF is merged into
the much larger disk QF by one streaming pass (paper Fig. 5), and the
I/O schedule is counted in :class:`IOCounters` inside the state.

The JAX package decides the flush with a ``lax.cond`` on the device
count; here it is a Python branch on one host read of the RAM QF's load
per insert batch.  Under ``backend="pallas"`` the flush decodes both
QFs with the decode kernel and rebuilds the disk QF with the build
kernel; the planes are the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..core import quotient_filter as qf
from . import iostats, qf_filter
from .iostats import IOCounters
from .registry import FilterImpl, register


class BufferedQFConfig(NamedTuple):
    ram_q: int  # log2 buckets of the RAM QF
    disk_q: int  # log2 buckets of the disk QF
    p: int  # fingerprint bits (q + r at both levels)
    slack: int = 1024
    disk_slack: int = 0  # 0 -> same as slack
    seed: int = 0
    max_load: float = 0.75
    backend: str = "reference"
    shrink_load: float = 0.4  # low watermark vs the halved disk QF

    @property
    def ram(self) -> qf.QFConfig:
        return qf.QFConfig(
            q=self.ram_q,
            r=self.p - self.ram_q,
            slack=self.slack,
            seed=self.seed,
            max_load=self.max_load,
        )

    @property
    def disk(self) -> qf.QFConfig:
        return qf.QFConfig(
            q=self.disk_q,
            r=self.p - self.disk_q,
            slack=self.disk_slack or self.slack,
            seed=self.seed,
            max_load=self.max_load,
        )


class BufferedQFState(NamedTuple):
    ram: qf.QFState
    disk: qf.QFState
    io: IOCounters


def make(device=None, **spec):
    cfg = BufferedQFConfig(**spec)
    if cfg.ram_q >= cfg.disk_q:
        raise ValueError("disk QF must be larger than the RAM QF")
    if not (cfg.ram_q < cfg.p and cfg.disk_q < cfg.p):
        raise ValueError("fingerprint bits p must exceed both quotients")
    qf_filter._check_backend(cfg)
    device = qf.resolve_device(device)
    return cfg, BufferedQFState(
        ram=qf.empty(cfg.ram, device),
        disk=qf.empty(cfg.disk, device),
        io=iostats.zeros(device),
    )


def flush(cfg: BufferedQFConfig, state: BufferedQFState) -> BufferedQFState:
    """Merge the RAM QF into the disk QF: stream old disk in, merged out."""
    disk = qf.merge(
        cfg.disk,
        cfg.disk,
        cfg.ram,
        state.disk,
        state.ram,
        build=qf_filter.build_fn(cfg.backend),
        extract=qf_filter.extract_fn(cfg.backend),
    )
    io = state.io._replace(
        seq_read_bytes=state.io.seq_read_bytes + cfg.disk.size_bytes,
        seq_write_bytes=state.io.seq_write_bytes + cfg.disk.size_bytes,
        flushes=state.io.flushes + 1,
        merges=state.io.merges + 1,
    )
    return BufferedQFState(ram=qf.empty(cfg.ram, disk.rem.device), disk=disk, io=io)


def insert(cfg: BufferedQFConfig, state, keys, k=None) -> BufferedQFState:
    """Insert a batch; flush the RAM QF into the disk QF once it is full."""
    ram = qf_filter.insert_keys(cfg.ram, cfg.backend, state.ram, keys, k)
    state = state._replace(ram=ram)
    full = qf.load(cfg.ram, ram) >= cfg.max_load
    with tracing.span("host_read.buffered.insert"):
        full = bool(full)
    if full:
        state = flush(cfg, state)
    return state


def _tier_hits(cfg: BufferedQFConfig, state, keys):
    ram_hit = qf_filter.contains_keys(cfg.ram, cfg.backend, state.ram, keys)
    disk_hit = qf_filter.contains_keys(cfg.disk, cfg.backend, state.disk, keys)
    return ram_hit, disk_hit


def contains(cfg: BufferedQFConfig, state, keys):
    ram_hit, disk_hit = _tier_hits(cfg, state, keys)
    return ram_hit | disk_hit


def probe(cfg: BufferedQFConfig, state, keys):
    """Lookup with the paper's I/O schedule: RAM misses each cost one
    random page read against the disk QF (cluster fits a page, §3)."""
    ram_hit, disk_hit = _tier_hits(cfg, state, keys)
    reads = torch.where(state.disk.n > 0, (~ram_hit).sum(dtype=torch.int32), 0)
    io = state.io._replace(rand_page_reads=state.io.rand_page_reads + reads)
    return state._replace(io=io), ram_hit | disk_hit


def delete(cfg: BufferedQFConfig, state, keys, k=None) -> BufferedQFState:
    """Remove one copy per key, RAM first, then disk.

    The j-th batch occurrence of a key targets the j-th stored copy
    across RAM-then-disk.  Disk-targeted deletes charge one random page
    read per targeted key and one random page write per copy removed."""
    valid = qf_filter.valid_mask(keys, k)
    rq, rr = qf.fingerprints(cfg.ram, keys)
    rank = qf_filter.batch_occurrence_rank(rq, rr, valid)
    cnt_ram = qf_filter.multiplicity(cfg.ram, cfg.backend, state.ram, rq, rr)
    ram = qf_filter.delete_masked(
        cfg.ram, cfg.backend, state.ram, rq, rr, valid & (rank < cnt_ram)
    )
    dq, dr = qf.fingerprints(cfg.disk, keys)
    disk_mask = valid & (rank >= cnt_ram)
    disk = qf_filter.delete_masked(
        cfg.disk, cfg.backend, state.disk, dq, dr, disk_mask
    )
    reads = torch.where(state.disk.n > 0, disk_mask.sum(dtype=torch.int32), 0)
    io = state.io._replace(
        rand_page_reads=state.io.rand_page_reads + reads,
        rand_page_writes=state.io.rand_page_writes + (state.disk.n - disk.n),
    )
    return BufferedQFState(ram=ram, disk=disk, io=io)


def merge(cfg: BufferedQFConfig, sa, sb) -> BufferedQFState:
    """Union of two buffered QFs (same cfg): disk_a + disk_b + ram_b
    stream into the new disk; ram_a stays the active buffer."""
    disk = qf.multi_merge(
        cfg.disk,
        [(cfg.disk, sa.disk), (cfg.disk, sb.disk), (cfg.ram, sb.ram)],
        build=qf_filter.build_fn(cfg.backend),
        extract=qf_filter.extract_fn(cfg.backend),
    )
    io = iostats.add(sa.io, sb.io)
    io = io._replace(
        seq_read_bytes=io.seq_read_bytes + 2.0 * cfg.disk.size_bytes,
        seq_write_bytes=io.seq_write_bytes + cfg.disk.size_bytes,
        merges=io.merges + 1,
    )
    return BufferedQFState(ram=sa.ram, disk=disk, io=io)


def needs_resize(cfg: BufferedQFConfig, state):
    """Bool scalar: the disk QF's load crossed ``max_load``, so the next
    flush would push it past the paper's operating point."""
    return qf.load(cfg.disk, state.disk) >= cfg.max_load


def _restream(cfg: BufferedQFConfig, new_disk: qf.QFConfig, disk_state):
    """One streaming requotient pass of the disk QF into a new geometry."""
    return qf.multi_merge(
        new_disk, [(cfg.disk, disk_state)], build=qf_filter.build_fn(cfg.backend),
        extract=qf_filter.extract_fn(cfg.backend),
    )


def resize(cfg: BufferedQFConfig, state, disk_q: int):
    """Re-split the disk QF at ``disk_q``.

    The disk QF is re-streamed once, a sequential read of the old
    structure and a sequential write of the new one, charged to
    ``IOCounters`` as the paper's merge schedule.
    """
    if not (cfg.ram_q < disk_q < cfg.p):
        raise ValueError(
            f"disk_q={disk_q} must lie strictly between ram_q={cfg.ram_q} "
            f"and p={cfg.p}"
        )
    new_cfg = cfg._replace(disk_q=disk_q)
    disk = _restream(cfg, new_cfg.disk, state.disk)
    io = state.io._replace(
        seq_read_bytes=state.io.seq_read_bytes + cfg.disk.size_bytes,
        seq_write_bytes=state.io.seq_write_bytes + new_cfg.disk.size_bytes,
        resizes=state.io.resizes + 1,
    )
    return new_cfg, BufferedQFState(ram=state.ram, disk=disk, io=io)


def grow(cfg: BufferedQFConfig, state):
    """One doubling step of the disk QF (steal one remainder bit)."""
    return resize(cfg, state, cfg.disk_q + 1)


def needs_shrink(cfg: BufferedQFConfig, state):
    """Bool scalar: the disk population fits the halved disk QF at the
    low watermark, so one narrower re-stream reclaims half the flash."""
    if cfg.disk_q - 1 <= cfg.ram_q:
        return torch.zeros((), dtype=torch.bool, device=state.disk.n.device)
    halved = cfg.disk._replace(q=cfg.disk_q - 1, r=cfg.disk.r + 1)
    return state.disk.n <= int(cfg.shrink_load * halved.capacity)


def shrink(cfg: BufferedQFConfig, state):
    """One halving step of the disk QF (re-merge a remainder bit)."""
    if cfg.disk_q - 1 <= cfg.ram_q:
        raise ValueError(
            f"cannot shrink disk_q={cfg.disk_q}: must stay above ram_q={cfg.ram_q}"
        )
    return resize(cfg, state, cfg.disk_q - 1)


def stats(cfg: BufferedQFConfig, state):
    return {
        "n": state.ram.n + state.disk.n,
        "ram_load": qf.load(cfg.ram, state.ram),
        "disk_load": qf.load(cfg.disk, state.disk),
        "overflow": state.ram.overflow | state.disk.overflow,
        "size_bytes": cfg.ram.size_bytes + cfg.disk.size_bytes,
        **state.io._asdict(),
    }


IMPL = register(
    FilterImpl(
        name="buffered_qf",
        paper_section="§4 (buffered QF: RAM buffer + one-pass merge to flash)",
        cfg_cls=BufferedQFConfig,
        make=make,
        insert=insert,
        contains=contains,
        stats=stats,
        delete=delete,
        merge=merge,
        probe=probe,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
    )
)
