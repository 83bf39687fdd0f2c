"""Cascade filter (paper §4) — legacy host-driven API.

The port of ``repro/core/cascade_filter.py``.

.. deprecated::
    New code should use the functional implementation behind the
    ``repro_torch.filters`` façade (``repro_torch.filters.make("cascade",
    ...)``).  This dataclass stays for host-driven callers that want
    lazily allocated levels or the deamortized I/O accounting below.

COLA-style hierarchy: a small RAM quotient filter Q0 plus on-"disk"
QFs Q_1..Q_l whose capacities grow geometrically with the fanout b.
When Q0 reaches its max load, the smallest i is found such that all
elements of Q0..Q_i fit in level i, and Q0..Q_i are k-way-merged into a
fresh Q_i (one sequential streaming pass); smaller levels empty.

Amortized insert cost: O(log_b(n/M) / B) block writes — each element is
rewritten once per level it passes through.  Lookup: one random page
read per non-empty level (short-circuited top-down).

``deamortize=True`` spreads each merge's I/O accounting over subsequent
insert batches — modeling the background-merge "cleaner" the paper
sketches in §6 (compute is applied immediately; only the modeled I/O
schedule is smoothed).

The levels live on ``device``: the card unless given ``"cpu"``.  On the
card Q0's inserts hash with the ``fingerprint`` kernel, every merge
builds with the ``qf_positions`` and ``qf_build_planes`` kernels and a
level's probe is one ``qf_probe`` launch; on the CPU the plain path
runs, as in the JAX shim.  Both give the same planes, hits and
``IOLog``.  The merge test, the merge-down's level counts and a
lookup's pending count are host reads, as in the JAX shim.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..filters import qf_filter
from ..kernels import dispatch
from . import quotient_filter as qf
from .cost_model import IOLog


@dataclass
class CascadeFilter:
    ram_q: int  # log2 buckets of Q0
    p: int  # fingerprint bits (q + r at every level)
    fanout: int = 2
    max_levels: int = 24
    seed: int = 0
    max_load: float = 0.75
    deamortize: bool = False
    io: IOLog = field(default_factory=IOLog)
    device: object = None

    def __post_init__(self):
        if self.fanout < 2 or (self.fanout & (self.fanout - 1)):
            raise ValueError("fanout must be a power of two >= 2")
        self.device = qf.resolve_device(self.device)
        self._backend = dispatch.backend_for(self.device)
        self.lb = int(math.log2(self.fanout))
        self.q0_cfg = self._cfg(self.ram_q)
        self.q0 = qf.empty(self.q0_cfg, self.device)
        # levels created lazily; level i has q = ram_q + (i+1)*log2(b)
        self.levels: list[tuple[qf.QFConfig, qf.QFState]] = []
        self._pending_io = 0.0  # deamortized bytes not yet charged

    def _cfg(self, q: int) -> qf.QFConfig:
        return qf.QFConfig(
            q=q,
            r=self.p - q,
            slack=max(1024, (1 << q) // 64),
            seed=self.seed,
            max_load=self.max_load,
        )

    def _level_cfg(self, i: int) -> qf.QFConfig:
        return self._cfg(self.ram_q + (i + 1) * self.lb)

    @property
    def count(self) -> int:
        return int(self.q0.n) + sum(int(s.n) for _, s in self.levels)

    @property
    def size_bytes(self) -> int:
        return self.q0_cfg.size_bytes + sum(c.size_bytes for c, _ in self.levels)

    # -- inserts ------------------------------------------------------------

    def insert(self, keys) -> None:
        keys = torch.as_tensor(keys, device=self.device)
        self.q0 = qf_filter.insert_keys(self.q0_cfg, self._backend, self.q0, keys)
        # float32 load against max_load, as the JAX shim compares them
        if float(qf.load(self.q0_cfg, self.q0)) >= self.max_load:
            self._merge_down()
        self._charge_pending(len(keys))

    def _merge_down(self) -> None:
        """Find the smallest level that fits Q0..Q_i and collapse into it."""
        n = int(self.q0.n)
        target = None
        for i in range(self.max_levels):
            cfg_i = self._level_cfg(i)
            n_i = n + sum(
                int(s.n) for _, s in self.levels[: i + 1] if s is not None
            )
            if n_i <= cfg_i.capacity:
                target = i
                n = n_i
                break
        if target is None:
            raise RuntimeError("cascade filter exhausted max_levels")
        while len(self.levels) <= target:
            c = self._level_cfg(len(self.levels))
            self.levels.append((c, qf.empty(c, self.device)))
        parts = [(self.q0_cfg, self.q0)] + [
            (c, s) for c, s in self.levels[: target + 1] if int(s.n) > 0
        ]
        cfg_t = self._level_cfg(target)
        merged = qf.multi_merge(
            cfg_t, parts, qf_filter.build_fn(self._backend),
            qf_filter.extract_fn(self._backend),
        )
        # I/O: stream every participating structure in, the target out
        read_bytes = sum(c.size_bytes for c, s in parts[1:])  # Q0 is RAM
        write_bytes = cfg_t.size_bytes
        if self.deamortize:
            self._pending_io += read_bytes + write_bytes
        else:
            self.io.seq_read_bytes += read_bytes
            self.io.seq_write_bytes += write_bytes
        self.io.merges += 1
        self.io.flushes += 1
        self.levels[target] = (cfg_t, merged)
        for j in range(target):
            c = self._level_cfg(j)
            self.levels[j] = (c, qf.empty(c, self.device))
        self.q0 = qf.empty(self.q0_cfg, self.device)

    def _charge_pending(self, batch: int) -> None:
        """Deamortized mode: charge buffered merge I/O smoothly."""
        if not self.deamortize or self._pending_io <= 0:
            return
        # charge proportionally to Q0 fill progress (one Q0 fill drains
        # at most one outstanding merge — the COLA deamortization rate)
        rate = self._pending_io * batch / max(1, self.q0_cfg.capacity)
        charge = min(self._pending_io, rate)
        self.io.seq_write_bytes += int(charge)
        self._pending_io -= charge

    # -- lookups ------------------------------------------------------------

    def lookup(self, keys) -> torch.Tensor:
        keys = torch.as_tensor(keys, device=self.device)
        hit = qf_filter.contains_keys(self.q0_cfg, self._backend, self.q0, keys)
        for cfg, state in self.levels:
            if int(state.n) == 0:
                continue
            pending = ~hit
            n_pending = int(pending.sum())
            if n_pending == 0:
                break
            lvl_hit = qf_filter.contains_keys(cfg, self._backend, state, keys)
            # short-circuit: only still-unresolved queries touch this level
            self.io.rand_page_reads += n_pending
            hit = hit | (pending & lvl_hit)
        return hit

    def n_nonempty_levels(self) -> int:
        return sum(1 for _, s in self.levels if int(s.n) > 0)
