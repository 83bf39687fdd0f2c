"""A quotient filter worked out from its keys, in plain PyTorch (paper §3).

A filter of ``2**q`` buckets and ``2**q + slack`` slots holds the
multiset of its keys' p-bit fingerprints, p = q + r.  In sorted order
the i-th fingerprint, with bucket ``fq`` (its top q bits) and remainder
``fr`` (its low r bits), sits at slot ``pos[i] = max(pos[i-1] + 1,
fq[i])``: linear probing in sorted order.  The table is four planes of
``2**q + slack`` entries:

- ``rem``: int32, the remainder at each filled slot, else 0;
- ``occ``: bool, bucket b holds a fingerprint whose quotient is b;
- ``shf``: bool, the fingerprint at the slot is not in its own bucket;
- ``con``: bool, the fingerprint at the slot has the quotient of the one
  before it.

with ``n``, the count (int32), and ``overflow`` (bool), a fingerprint
past the last slot, which is then dropped.  The planes are a function of
the multiset alone, so a filter is worked out from all its keys at once,
whatever batches they came in.

``Model`` is the flat ``qf`` family: the keys it was given, its planes
and exact membership.  ``drop`` takes that many low bits off every
fingerprint (the remainder narrows, the quotient stays): the same filter
at a lower precision.

A family's module also says how the program's state is read and judged:
``read_state`` gives each quotient filter of a state of the program as
a dict of its fields, ``compare`` counts where they differ from the
reference's.  The program's state is read by its fields' names alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fingerprint import fingerprints


class Geometry(NamedTuple):
    q: int
    r: int
    slack: int

    @property
    def slots(self) -> int:
        return (1 << self.q) + self.slack


def sorted_fingerprints(batches, p: int, seed: int, device) -> torch.Tensor:
    """The sorted p-bit fingerprints of every key in ``batches``."""
    if not batches:
        return torch.zeros(0, dtype=torch.int64, device=device)
    parts = [fingerprints(b, p, seed) for b in batches]
    return torch.sort(torch.cat(parts)).values


def empty(geo: Geometry, device) -> dict:
    t = geo.slots
    return {
        "rem": torch.zeros(t, dtype=torch.int32, device=device),
        "occ": torch.zeros(t, dtype=torch.bool, device=device),
        "shf": torch.zeros(t, dtype=torch.bool, device=device),
        "con": torch.zeros(t, dtype=torch.bool, device=device),
        "n": torch.zeros((), dtype=torch.int32, device=device),
        "overflow": torch.zeros((), dtype=torch.bool, device=device),
    }


def build(f: torch.Tensor, geo: Geometry) -> dict:
    """The planes of a filter of geometry ``geo`` holding the sorted
    (q + r)-bit fingerprints ``f``."""
    out = empty(geo, f.device)
    n = f.shape[0]
    out["n"].fill_(n)
    if n == 0:
        return out
    fq = f >> geo.r
    fr = f & ((1 << geo.r) - 1)
    i = torch.arange(n, device=f.device)
    pos = i + torch.cummax(fq - i, 0).values
    same = torch.zeros(n, dtype=torch.bool, device=f.device)
    same[1:] = fq[1:] == fq[:-1]
    keep = pos < geo.slots
    out["overflow"].fill_(bool((~keep).any()))
    slot = pos[keep]
    out["rem"][slot] = fr[keep].to(torch.int32)
    out["shf"][slot] = (pos != fq)[keep]
    out["con"][slot] = same[keep]
    out["occ"][fq] = True
    return out


QF_FIELDS = ("rem", "occ", "shf", "con", "n", "overflow")
PLANES = ("rem", "occ", "shf", "con")


def read_state(state) -> list:
    """Each quotient filter of a state of the program (every tuple with
    ``QF_FIELDS``, in field order: a cascade's Q0, then its levels) as a
    dict of its fields."""
    if getattr(state, "_fields", None) == QF_FIELDS:
        return [state._asdict()]
    if isinstance(state, torch.Tensor):
        return []
    return [s for part in state for s in read_state(part)]


def compare(port: list, ref: list) -> dict:
    """The numbers compared for a state: ``plane_mismatches``, slots of
    any plane of any filter that differ from the reference's;
    ``count_gap``, the sum of |n - reference n|; ``overflow_flags``,
    filters whose ``overflow`` is set (the configuration guarantees
    none)."""
    if len(port) != len(ref):
        raise ValueError(f"the program holds {len(port)} filters, the reference {len(ref)}")
    planes = gap = overflow = 0
    for a, b in zip(port, ref):
        for k in PLANES:
            planes += int((a[k] != b[k]).sum())
        gap += abs(int(a["n"]) - int(b["n"]))
        overflow += int(bool(a["overflow"]))
    return {"plane_mismatches": planes, "count_gap": gap, "overflow_flags": overflow}


def visits(held: list, f: torch.Tensor) -> torch.Tensor:
    """For each fingerprint of ``f``, the filters a probe must read, top
    down, up to the first that holds it; empty filters are not read.
    ``held`` is each filter's sorted fingerprints."""
    pending = torch.ones(f.shape[0], dtype=torch.bool, device=f.device)
    out = torch.zeros(f.shape[0], dtype=torch.int64, device=f.device)
    for h in held:
        if h.shape[0] == 0:
            continue
        out += pending
        pending &= ~member(h, f)
    return out


def member(held: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Which of ``f`` are among the sorted fingerprints ``held``."""
    if held.shape[0] == 0:
        return torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
    at = torch.searchsorted(held, f).clamp(max=held.shape[0] - 1)
    return held[at] == f


class Model:
    """The ``qf`` family at ``spec`` (``q``, ``r``, ``slack``, ``seed``)."""

    def __init__(self, spec: dict, device, drop: int = 0):
        self.geo = Geometry(spec["q"], spec["r"] - drop, spec["slack"])
        self.geos = [self.geo]
        self.max_load = spec.get("max_load", 0.75)
        self.seed = spec.get("seed", 0)
        self.device = device
        self.batches: list = []
        self._held = None

    @property
    def p(self) -> int:
        return self.geo.q + self.geo.r

    def copy(self) -> "Model":
        other = object.__new__(Model)
        other.__dict__.update(self.__dict__, batches=list(self.batches))
        return other

    def insert(self, keys: torch.Tensor) -> None:
        self.batches.append(keys)
        self._held = None

    def held(self) -> list:
        """Each structure's sorted fingerprints, top-down: here one."""
        if self._held is None:
            self._held = sorted_fingerprints(self.batches, self.p, self.seed, self.device)
        return [self._held]

    def structures(self) -> list:
        return [build(self.held()[0], self.geo)]

    def capacity(self) -> int:
        """Keys the filter is built to hold, rounded down as the program
        rounds it."""
        return int((1 << self.geo.q) * self.max_load)

    def contains(self, keys: torch.Tensor) -> torch.Tensor:
        return member(self.held()[0], fingerprints(keys, self.p, self.seed))

    def visits(self, keys: torch.Tensor) -> torch.Tensor:
        return visits(self.held(), fingerprints(keys, self.p, self.seed))
