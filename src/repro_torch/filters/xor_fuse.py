"""``xor_fuse`` — the frozen (construct-only) binary-fuse family.

The port of ``repro.filters.xor_fuse``.  A binary-fuse filter
(``repro_torch.core.fuse_filter``) is built once from its key set and
then answers ``contains``/``probe`` with exactly three table reads.
``insert`` and ``delete`` are unbound: the façade raises a structured
:class:`~repro_torch.filters.registry.UnsupportedOpError`, and updates
happen by reconstruction — ``merge`` two frozen filters, ``extend`` one
with a raw key batch, or ``grow``/``resize``/``shrink`` it, each one
re-peel from the retained sorted fingerprint runs.

``backend="pallas"`` routes probes through the ``fuse_probe`` kernel
path (``kernels.ops.fuse_contains``); ``"reference"`` runs the plain
3-gather.  Hits, stats and I/O counters are backend-invariant.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import cost_model
from ..core import fuse_filter as fuse
from ..core import quotient_filter as qf
from ..kernels import ops as kernel_ops
from . import iostats
from .iostats import IOCounters
from .registry import FilterImpl, register

BACKENDS = ("reference", "pallas")


class XorFuseConfig(NamedTuple):
    """Static geometry + backend; ``core`` rebuilds the ``FuseConfig``."""

    p: int
    fp_bits: int
    segment_length: int
    segment_count: int
    capacity: int
    seed: int = 0
    backend: str = "reference"

    @property
    def core(self) -> fuse.FuseConfig:
        return fuse.FuseConfig(*self[:6])

    @property
    def size_bytes(self) -> int:
        """Probe-structure bytes (the resident, randomly read tier)."""
        return self.core.size_bytes

    @property
    def run_bytes(self) -> int:
        """Retained-run bytes (sequential-only; read by reconstruction)."""
        return self.core.run_bytes

    @property
    def bits_per_key(self) -> float:
        return self.core.slots * self.fp_bits / max(self.capacity, 1)


class XorFuseState(NamedTuple):
    core: fuse.FuseState
    io: IOCounters


def _cfg_from_core(core: fuse.FuseConfig, backend: str) -> XorFuseConfig:
    return XorFuseConfig(*core, backend=backend)


def make(
    capacity: Optional[int] = None,
    p: int = 26,
    keys=None,
    fp_bits: Optional[int] = None,
    seed: int = 0,
    backend: str = "reference",
    segment_length: Optional[int] = None,
    segment_count: Optional[int] = None,
    device=None,
):
    """Construct a frozen filter: ``make(keys=...)`` builds it outright,
    ``make(capacity=...)`` sizes an empty one for later ``merge``/
    ``extend`` unions (both may be given; capacity must then cover the
    keys).  ``segment_count`` is normally derived; accepting it keeps
    ``make(**cfg._asdict())`` round trips exact."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if capacity is None:
        if keys is None:
            raise ValueError("xor_fuse.make needs capacity=, keys=, or both")
        capacity = max(int(keys.shape[0]), 1)
    if segment_count is not None:
        core = fuse.FuseConfig(
            p=p,
            fp_bits=fp_bits,
            segment_length=segment_length,
            segment_count=segment_count,
            capacity=capacity,
            seed=seed,
        )
    else:
        core = fuse.make_config(
            capacity, p, fp_bits=fp_bits, seed=seed, segment_length=segment_length
        )
    device = qf.resolve_device(device)
    io = iostats.zeros(device)
    if keys is None:
        st = fuse.empty(core, device)
    else:
        st = fuse.freeze_keys(core, torch.as_tensor(keys, device=device))
        # construction streams the key set in and writes table + run out
        io = io._replace(
            seq_write_bytes=iostats.f32(core.size_bytes + core.run_bytes, device),
            flushes=torch.ones((), dtype=torch.int32, device=device),
        )
    return _cfg_from_core(core, backend), XorFuseState(core=st, io=io)


def _lookup(cfg: XorFuseConfig, core_state: fuse.FuseState, keys):
    if cfg.backend == "pallas":
        return kernel_ops.fuse_contains(cfg.core, core_state, keys)
    return fuse.contains(cfg.core, core_state, keys)


def contains(cfg: XorFuseConfig, state: XorFuseState, keys):
    return _lookup(cfg, state.core, keys)


def probe(cfg: XorFuseConfig, state: XorFuseState, keys):
    """``contains`` + the 3-read access schedule per query
    (``cost_model.FUSE_PROBE_READS``), charged when the filter holds keys."""
    hit = _lookup(cfg, state.core, keys)
    reads = torch.where(
        state.core.n > 0, cost_model.FUSE_PROBE_READS * keys.shape[0], 0
    ).to(torch.int32)
    io = state.io._replace(rand_page_reads=state.io.rand_page_reads + reads)
    return state._replace(io=io), hit


def _refreeze(cfg: XorFuseConfig, fq, fr, n: int, io: IOCounters) -> XorFuseState:
    if n > cfg.capacity:
        raise ValueError(
            f"union of {n} fingerprints exceeds frozen capacity "
            f"{cfg.capacity}; make the filter with a larger capacity"
        )
    st = fuse.freeze(cfg.core, fq, fr, n)
    dev = fq.device
    io = io._replace(
        seq_read_bytes=io.seq_read_bytes + iostats.f32(cfg.run_bytes, dev),
        seq_write_bytes=io.seq_write_bytes
        + iostats.f32(cfg.size_bytes + cfg.run_bytes, dev),
        merges=io.merges + 1,
    )
    return XorFuseState(core=st, io=io)


def merge(cfg: XorFuseConfig, sa: XorFuseState, sb: XorFuseState) -> XorFuseState:
    """Union two frozen filters (same cfg): merge the retained sorted
    runs in O(n) and re-peel."""
    a, b = sa.core, sb.core
    mq, mr = qf.merge_streams(a.run_q, a.run_r, a.n, b.run_q, b.run_r, b.n)
    n = int(a.n + b.n)  # one read: the capacity check and the re-peel's size
    return _refreeze(cfg, mq, mr, n, iostats.add(sa.io, sb.io))


def extend(cfg: XorFuseConfig, state: XorFuseState, keys) -> XorFuseState:
    """Union a frozen filter with a raw key batch: one full re-peel per
    call (reconstruction, not insertion; batch your updates)."""
    keys = torch.as_tensor(keys, device=state.core.n.device)
    fq, fr = fuse.key_fingerprints(cfg.core, keys)
    sq, sr = qf._pad_sort(fq, fr, torch.ones_like(fq, dtype=torch.bool))
    c = state.core
    mq, mr = qf.merge_streams(c.run_q, c.run_r, c.n, sq, sr, keys.shape[0])
    n = int(c.n) + int(keys.shape[0])
    return _refreeze(cfg, mq, mr, n, state.io)


def needs_resize(cfg: XorFuseConfig, state: XorFuseState):
    return state.core.n >= cfg.capacity


SHRINK_LOAD = 0.4  # the QF families' hysteresis default; fixed, as in the reference


def needs_shrink(cfg: XorFuseConfig, state: XorFuseState):
    if cfg.capacity < 2:
        return torch.zeros((), dtype=torch.bool, device=state.core.n.device)
    return state.core.n <= int(SHRINK_LOAD * (cfg.capacity // 2))


def resize(cfg: XorFuseConfig, state: XorFuseState, capacity: int):
    """Re-freeze at a new design capacity (one re-peel)."""
    new_core = fuse.make_config(capacity, cfg.p, fp_bits=cfg.fp_bits, seed=cfg.seed)
    c = state.core
    if int(c.n) > capacity:
        raise ValueError("new capacity below the current population")
    st = fuse.freeze(new_core, c.run_q, c.run_r, int(c.n))
    dev = c.n.device
    io = state.io._replace(
        seq_read_bytes=state.io.seq_read_bytes + iostats.f32(cfg.run_bytes, dev),
        seq_write_bytes=state.io.seq_write_bytes
        + iostats.f32(new_core.size_bytes + new_core.run_bytes, dev),
        resizes=state.io.resizes + 1,
    )
    return _cfg_from_core(new_core, cfg.backend), XorFuseState(core=st, io=io)


def grow(cfg: XorFuseConfig, state: XorFuseState):
    return resize(cfg, state, capacity=cfg.capacity * 2)


def shrink(cfg: XorFuseConfig, state: XorFuseState):
    """Halve the design capacity by one re-peel (fewer slots, same
    fp_bits: unlike the QF's bit re-merge, the fp rate is unchanged)."""
    return resize(cfg, state, capacity=max(cfg.capacity // 2, 1))


def stats(cfg: XorFuseConfig, state: XorFuseState) -> dict:
    return {
        "n": state.core.n,
        "n_unique": state.core.n_unique,
        "overflow": state.core.overflow,
        "load": state.core.n / torch.tensor(float(cfg.capacity), dtype=torch.float32),
        "slots": cfg.core.slots,
        "fp_bits": cfg.fp_bits,
        "bits_per_key": cfg.bits_per_key,
        "size_bytes": cfg.size_bytes,
        "run_bytes": cfg.run_bytes,
        **state.io._asdict(),
    }


IMPL = register(
    FilterImpl(
        name="xor_fuse",
        paper_section="§4 cold levels, frozen (beyond-paper: binary fuse filter)",
        cfg_cls=XorFuseConfig,
        make=make,
        insert=None,  # frozen: the façade raises UnsupportedOpError
        contains=contains,
        stats=stats,
        delete=None,
        merge=merge,
        probe=probe,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
        op_hints={
            "insert": "frozen family — build with make(keys=...), or union "
            "batches via merge()/xor_fuse.extend() (full re-peel per call)",
            "delete": "frozen family — rebuild without the evicted keys, or "
            "use a QF-backed family where deletes are hot-path",
        },
    )
)
