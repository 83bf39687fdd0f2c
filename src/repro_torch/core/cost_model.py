"""Memory-hierarchy cost models (a verbatim copy of ``repro.core.cost_model``).

The port keeps its own copy because importing the JAX package's module
runs that package's ``__init__``, which imports jax.  Keep the two in
step: the I/O counters of both packages are compared field by field.

The paper's evaluation is throughput on a concrete hierarchy
(3 GB RAM + Intel X25-M SSD).  No SSD is attached to the structures,
so on-"disk" structures account their exact access schedule
(random page reads/writes, sequential bytes) into an :class:`IOLog`,
and a profile converts the log into modeled seconds.

Two calibrations ship:

* :data:`PAPER_SSD` — the paper's own measured constants (§1/Table 1
  context: 3,910 random 1-byte writes/s, 3,200 random reads/s,
  261 MB/s sequential read, 109 MB/s sequential write, 4 KiB pages).
  Used by the Table-1b reproduction benchmarks.
* :data:`TPU_V5E` — the target hardware for the JAX port: HBM streaming
  vs gather-limited access plus ICI hops for the sharded filter.
  Used by the beyond-paper analysis in EXPERIMENTS.md.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class HierarchyProfile:
    name: str
    rand_read_ops_per_s: float  # random page reads / second
    rand_write_ops_per_s: float  # random page writes / second
    seq_read_bytes_per_s: float
    seq_write_bytes_per_s: float
    page_bytes: int
    ram_bytes: int  # "fast tier" budget


PAPER_SSD = HierarchyProfile(
    name="intel-x25m-paper",
    rand_read_ops_per_s=3_200.0,
    rand_write_ops_per_s=3_910.0,
    seq_read_bytes_per_s=261e6,
    seq_write_bytes_per_s=109e6,
    page_bytes=4096,
    ram_bytes=2 << 30,  # 2 GB filter budget in the paper's experiments
)

# TPU v5e: HBM streams at 819 GB/s; "random" page access modeled as one
# 512 B gather transaction at an effective ~10x bandwidth derate
# (gather-limited HBM); ICI ~50 GB/s/link is tracked separately by the
# roofline harness, not here.
TPU_V5E = HierarchyProfile(
    name="tpu-v5e-hbm",
    rand_read_ops_per_s=819e9 / 512 / 10,
    rand_write_ops_per_s=819e9 / 512 / 10,
    seq_read_bytes_per_s=819e9,
    seq_write_bytes_per_s=819e9,
    page_bytes=512,
    ram_bytes=128 << 20,  # VMEM
)


@dataclass
class IOLog:
    """Exact access schedule of an on-"disk" structure."""

    rand_page_reads: int = 0
    rand_page_writes: int = 0
    seq_read_bytes: int = 0
    seq_write_bytes: int = 0
    # informational
    flushes: int = 0
    merges: int = 0
    notes: dict = field(default_factory=dict)

    def clear(self) -> None:
        self.rand_page_reads = 0
        self.rand_page_writes = 0
        self.seq_read_bytes = 0
        self.seq_write_bytes = 0
        self.flushes = 0
        self.merges = 0

    def snapshot(self) -> "IOLog":
        return IOLog(
            rand_page_reads=self.rand_page_reads,
            rand_page_writes=self.rand_page_writes,
            seq_read_bytes=self.seq_read_bytes,
            seq_write_bytes=self.seq_write_bytes,
            flushes=self.flushes,
            merges=self.merges,
        )

    def delta(self, since: "IOLog") -> "IOLog":
        return IOLog(
            rand_page_reads=self.rand_page_reads - since.rand_page_reads,
            rand_page_writes=self.rand_page_writes - since.rand_page_writes,
            seq_read_bytes=self.seq_read_bytes - since.seq_read_bytes,
            seq_write_bytes=self.seq_write_bytes - since.seq_write_bytes,
            flushes=self.flushes - since.flushes,
            merges=self.merges - since.merges,
        )


def modeled_seconds(log: IOLog, profile: HierarchyProfile) -> float:
    """Convert an access schedule into modeled I/O seconds."""
    return (
        log.rand_page_reads / profile.rand_read_ops_per_s
        + log.rand_page_writes / profile.rand_write_ops_per_s
        + log.seq_read_bytes / profile.seq_read_bytes_per_s
        + log.seq_write_bytes / profile.seq_write_bytes_per_s
    )


def modeled_throughput(n_ops: int, log: IOLog, profile: HierarchyProfile) -> float:
    """ops/second implied by the schedule (inf if no I/O was needed)."""
    secs = modeled_seconds(log, profile)
    return float("inf") if secs == 0 else n_ops / secs


# ---------------------------------------------------------------------------
# Frozen-tier geometry: binary-fuse vs quotient-filter cold levels
# ---------------------------------------------------------------------------
#
# A cascade level below Q0 is write-once between merge-downs, which is
# the contract the Graf & Lemire xor / binary-fuse filters exploit: an
# immutable table of ~1.125-1.4x n fingerprint cells (3-wise segmented
# layout) answered by exactly FUSE_PROBE_READS independent reads.  The
# helpers below are the single source of truth for that geometry —
# ``core.fuse_filter`` sizes its tables with them, the cascade's
# ``frozen_below`` mode derives per-level fuse configs from them, and
# ``benchmarks/bench_xor_fuse.py`` + the cost-model unit test validate
# the predictions against measured ``IOCounters``.

FUSE_ARITY = 3
#: independent table reads per probe (the xor-filter access schedule);
#: the three touched segments are consecutive, so on a page device they
#: often coalesce, but the *schedule* is three independent gathers.
FUSE_PROBE_READS = 3
#: QF cluster lookups touch one contiguous region = one page.
QF_PROBE_READS = 1


def fuse_segment_length(capacity: int) -> int:
    """Binary-fuse segment length (power of two) for a design capacity.

    Follows the Graf & Lemire sizing shape: segments grow slowly with n
    (``~ n ** (1/log 3.33)``), clamped to [16, 4096].
    """
    if capacity <= 1:
        return 16
    raw = int(math.floor(math.log(capacity) / math.log(3.33) + 2.25))
    return 1 << max(4, min(12, raw))


def fuse_size_factor(capacity: int) -> float:
    """Table-slots-per-key expansion at which 3-wise peeling succeeds whp.

    Large sets approach the asymptotic 1.125; small sets need
    proportionally more head-room (Graf & Lemire's small-n correction),
    plus a safety margin since construction retries are host-level.
    """
    n = max(capacity, 8)
    return max(1.125, 0.875 + 0.30 * math.log(1e6) / math.log(n))


def fuse_segment_count(capacity: int, segment_length: int | None = None) -> int:
    L = segment_length or fuse_segment_length(capacity)
    need = fuse_size_factor(capacity) * max(capacity, 1)
    return max(1, math.ceil(need / L) - 2)


def fuse_slots(capacity: int, segment_length: int | None = None) -> int:
    """Total fingerprint cells of a binary-fuse table sized for ``capacity``."""
    L = segment_length or fuse_segment_length(capacity)
    return (fuse_segment_count(capacity, L) + 2) * L


def fuse_bits_per_key(
    capacity: int, fp_bits: int, segment_length: int | None = None
) -> float:
    """Modeled probe-structure bits per key of a frozen (binary-fuse) level."""
    return fuse_slots(capacity, segment_length) * fp_bits / max(capacity, 1)


def qf_bits_per_key(q: int, r: int, slack: int, max_load: float = 0.75) -> float:
    """Modeled bits per key of a QF level at its design capacity.

    (r + 3 metadata bits) per slot over m + slack slots, against the
    ``max_load * m`` keys the level is sized to hold.
    """
    m = 1 << q
    return (m + slack) * (r + 3) / (m * max_load)


def fuse_fp_bits_for(r: int, max_load: float = 0.75) -> int:
    """Stored fingerprint width matching a QF level's fp rate.

    A QF at load ``a`` false-positives at ``~a * 2^-r``; a fuse table at
    ``2^-f``.  ``f = r + ceil(log2(1/a))`` makes the frozen level at
    least as selective.  Clamped to the uint32 cell layout.
    """
    extra = max(0, math.ceil(-math.log2(max_load)))
    return max(4, min(28, r + extra))


def frozen_level_saving(
    q: int,
    r: int,
    slack: int,
    max_load: float = 0.75,
    fp_bits: int | None = None,
) -> float:
    """Fractional probe-structure space saved by demoting one QF level
    to binary-fuse form at the same fp-rate target (positive = smaller)."""
    capacity = int((1 << q) * max_load)
    f = fp_bits if fp_bits is not None else fuse_fp_bits_for(r, max_load)
    qf_bits = qf_bits_per_key(q, r, slack, max_load)
    fz_bits = fuse_bits_per_key(capacity, f)
    return 1.0 - fz_bits / qf_bits


def recommend_frozen_below(
    ram_q: int,
    p: int,
    fanout: int = 2,
    levels: int = 4,
    max_load: float = 0.75,
    min_saving: float = 0.10,
) -> int | None:
    """Smallest cascade depth k at which demoting levels >= k to
    binary-fuse form saves at least ``min_saving`` of their
    probe-structure bits — the family auto-pick hook.

    Returns None when no depth clears the bar (e.g. tiny levels where
    segment-granularity padding eats the win).
    """
    lb = int(math.log2(fanout))
    for i in range(levels):
        q = ram_q + (i + 1) * lb
        r = p - q
        if r < 2:
            continue
        slack = max(1024, (1 << q) // 64)
        if frozen_level_saving(q, r, slack, max_load) >= min_saving:
            return i
    return None


def cascade_probe_reads(
    n_queries: int, nonempty: list, frozen: list | None = None
) -> int:
    """Predicted ``rand_page_reads`` for probing ``n_queries`` all-miss
    keys through a cascade: every query stays pending at every level, so
    each non-empty level charges one cluster read (QF) or
    ``FUSE_PROBE_READS`` gathers (frozen) per query.  Validated against
    measured ``IOCounters`` in ``tests/test_xor_fuse.py``.
    """
    frozen = frozen or [False] * len(nonempty)
    reads = 0
    for ne, fz in zip(nonempty, frozen):
        if ne:
            reads += n_queries * (FUSE_PROBE_READS if fz else QF_PROBE_READS)
    return reads
