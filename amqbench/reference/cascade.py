"""A cascade filter worked out from its keys, in plain PyTorch (paper §4).

A RAM quotient filter Q0 of ``2**ram_q`` buckets sits above ``levels``
filters whose bucket counts grow by ``fanout``: level i has
``q = ram_q + (i + 1) log2(fanout)``, and every structure keeps the same
p-bit fingerprints (r = p - q), with ``max(1024, 2**q / 64)`` slots of
slack.  A batch goes into Q0.  Once Q0's load (its count over its
buckets, in float32) reaches ``max_load``, Q0 and levels 0..i merge into
a fresh level i, where i is the first level whose capacity,
``int(2**q * max_load)``, holds Q0 and every level down to it; Q0 and
the levels above i are left empty.  Where no level holds them, Q0 keeps
its keys.

Which batches each structure holds follows from the counts alone, so
``Model.insert`` only keeps that schedule; the planes of each structure
are worked out from its keys when asked for (``reference.qf.build``).
A structure's ``overflow`` is that of its own build: a run that
overflows anywhere is not correct, whatever the flag says.
"""

from __future__ import annotations

import numpy as np
import torch

from .fingerprint import fingerprints
from .qf import Geometry, build, compare, member, read_state, sorted_fingerprints, visits

__all__ = ["Model", "compare", "read_state"]


class Model:
    """The ``cascade`` family at ``spec`` (``ram_q``, ``p``, ``fanout``,
    ``levels``, ``max_load``, ``seed``), without frozen levels."""

    def __init__(self, spec: dict, device, drop: int = 0):
        if spec.get("frozen_below") is not None:
            raise ValueError("the reference holds quotient-filter levels only")
        lb = int(spec["fanout"]).bit_length() - 1
        p = spec["p"]
        self.ram_q = spec["ram_q"]
        self.max_load = spec.get("max_load", 0.75)
        self.seed = spec.get("seed", 0)
        self.device = device
        self.drop = drop
        qs = [self.ram_q] + [self.ram_q + (i + 1) * lb for i in range(spec["levels"])]
        self.geos = [Geometry(q, p - q - drop, max(1024, (1 << q) // 64)) for q in qs]
        self.caps = [int((1 << q) * self.max_load) for q in qs[1:]]
        self.batches: list = []
        self.held_by: list = [[] for _ in qs]  # batch indices in each structure
        self.counts = [0] * len(qs)
        self._held = None

    @property
    def p(self) -> int:
        g = self.geos[0]
        return g.q + g.r

    def copy(self) -> "Model":
        other = object.__new__(Model)
        other.__dict__.update(
            self.__dict__,
            batches=list(self.batches),
            held_by=[list(h) for h in self.held_by],
            counts=list(self.counts),
        )
        return other

    def collapse_target(self):
        """The level Q0 merges into now, or None."""
        q0 = self.counts[0]
        full = np.float32(q0) / np.float32(1 << self.ram_q) >= np.float32(self.max_load)
        if not full:
            return None
        cum = q0
        for i, cap in enumerate(self.caps):
            cum += self.counts[i + 1]
            if cum <= cap:
                return i
        return None

    def insert(self, keys: torch.Tensor) -> None:
        self.batches.append(keys)
        self.held_by[0].append(len(self.batches) - 1)
        self.counts[0] += keys.shape[0]
        self._held = None
        i = self.collapse_target()
        if i is None:
            return
        moved = [b for s in range(i + 2) for b in self.held_by[s]]
        total = sum(self.counts[: i + 2])
        for s in range(i + 2):
            self.held_by[s], self.counts[s] = [], 0
        self.held_by[i + 1], self.counts[i + 1] = sorted(moved), total

    def held(self) -> list:
        """Each structure's sorted fingerprints, Q0 first."""
        if self._held is None:
            self._held = [
                sorted_fingerprints([self.batches[b] for b in h], self.p, self.seed, self.device)
                for h in self.held_by
            ]
        return self._held

    def structures(self) -> list:
        return [build(f, g) for f, g in zip(self.held(), self.geos)]

    def capacity(self) -> int:
        """Keys the cascade is built to hold: every structure's, Q0's too."""
        return int((1 << self.ram_q) * self.max_load) + sum(self.caps)

    def contains(self, keys: torch.Tensor) -> torch.Tensor:
        f = fingerprints(keys, self.p, self.seed)
        hit = torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
        for held in self.held():
            hit |= member(held, f)
        return hit

    def visits(self, keys: torch.Tensor) -> torch.Tensor:
        return visits(self.held(), fingerprints(keys, self.p, self.seed))
