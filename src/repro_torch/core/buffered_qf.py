"""Buffered quotient filter (paper §4) — legacy host-driven API.

The port of ``repro/core/buffered_qf.py``.

.. deprecated::
    This dataclass is a thin shim over the functional implementation in
    :mod:`repro_torch.filters.buffered`
    (``repro_torch.filters.make("buffered_qf", ...)``), kept for
    host-driven callers and the historical tests.  New code should use
    the ``repro_torch.filters`` façade.

One QF in RAM buffers inserts; when it hits the paper's 3/4 load it is
flushed into the (much larger) on-"disk" QF by a single sequential
merge.  Lookups check the RAM QF and then perform one random page read
against the disk QF (the cluster fits a page — the paper's headline
locality property).

The state lives on ``device``: the card unless given ``"cpu"``.  On the
card the shim takes the kernel path (``backend="pallas"``), on the CPU
the plain one (``"reference"``, as the JAX shim does); the two compute
the same planes, hits and I/O counters.

Amortized insert cost: O(n / (M B)) block writes — every flush streams
the whole disk structure once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..filters import buffered as fb
from ..filters.iostats import to_iolog
from ..kernels import dispatch
from . import quotient_filter as qf
from .cost_model import IOLog


@dataclass
class BufferedQuotientFilter:
    ram_cfg: qf.QFConfig
    disk_cfg: qf.QFConfig
    device: object = None

    def __post_init__(self):
        if self.ram_cfg.q + self.ram_cfg.r != self.disk_cfg.q + self.disk_cfg.r:
            raise ValueError("RAM and disk QFs must share fingerprint width")
        if self.ram_cfg.seed != self.disk_cfg.seed:
            raise ValueError("RAM and disk QFs must share the hash seed")
        self.device = qf.resolve_device(self.device)
        self._fcfg, self._fstate = fb.make(
            device=self.device,
            ram_q=self.ram_cfg.q,
            disk_q=self.disk_cfg.q,
            p=self.ram_cfg.q + self.ram_cfg.r,
            slack=self.ram_cfg.slack,
            disk_slack=self.disk_cfg.slack,
            seed=self.ram_cfg.seed,
            max_load=self.ram_cfg.max_load,
            backend=dispatch.backend_for(self.device),
        )

    # -- state views ---------------------------------------------------------

    @property
    def ram(self) -> qf.QFState:
        return self._fstate.ram

    @property
    def disk(self) -> qf.QFState:
        return self._fstate.disk

    @property
    def io(self) -> IOLog:
        """Host snapshot of the device-resident I/O counters."""
        return to_iolog(self._fstate.io)

    @property
    def count(self) -> int:
        return int(self._fstate.ram.n) + int(self._fstate.disk.n)

    # -- ops -----------------------------------------------------------------

    def insert(self, keys) -> None:
        keys = torch.as_tensor(keys, device=self.device)
        self._fstate = fb.insert(self._fcfg, self._fstate, keys)

    def flush(self) -> None:
        """Sequential merge of the RAM QF into the disk QF (paper Fig. 5)."""
        self._fstate = fb.flush(self._fcfg, self._fstate)

    def lookup(self, keys) -> torch.Tensor:
        keys = torch.as_tensor(keys, device=self.device)
        self._fstate, hit = fb.probe(self._fcfg, self._fstate, keys)
        return hit
