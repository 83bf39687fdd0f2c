"""Binary-fuse (3-wise xor) filter core, bit for bit ``repro.core.fuse_filter``.

The frozen cold tier: each key maps to one cell in each of three
*consecutive* segments, and membership is ``fp(x) == T[h0] ^ T[h1] ^
T[h2]``.  A cascade level below Q0 is write-once between merge-downs,
so the cascade's ``frozen_below`` mode demotes merged-down levels into
this form, and the ``xor_fuse`` family is one such table on its own.

Construction peels the 3-uniform hypergraph of the deduplicated
fingerprints in parallel rounds (every key incident to a degree-1 cell
peels in the round), then replays the rounds in reverse, one gather,
xor and scatter per round.  The JAX package runs both loops on the
device (``lax.while_loop``/``fori_loop``) over ``capacity``-long masked
planes; here they run over the ``n_unique`` live keys only (masked
lanes change nothing), and the result is the same table bit for bit:

* the peel's test for "no key peeled" is a host read, so it runs
  :data:`PEEL_SYNC_EVERY` rounds between reads, compacting the alive
  keys at each read.  A round in which no key peels changes nothing,
  and so does every round after it, so the extra rounds are exact;
* keys are sorted by round once, so the replay walks each round's
  keys as one slice: O(n) over all rounds.

A seed that leaves a 2-core is retried with the next seed of the
reference's schedule, up to :data:`MAX_PEEL_ATTEMPTS`; if every seed
fails the state is flagged ``overflow`` with a zero table, as in the
reference.  :data:`peel_counts` adds up the attempts, rounds and host
reads of every freeze.

Representation: ``table`` is int32 holding the cells (below 2**28, so
the bit pattern of the reference's uint32); the retained run
``run_q``/``run_r`` is an int64 canonical fingerprint stream in the
port's convention (sorted by the packed key, sentinel-padded to
``capacity``); ``n``, ``n_unique`` and ``fuse_seed`` are int32 scalar
tensors and ``overflow`` a bool scalar tensor.
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from . import cost_model
from .fingerprint import M32, _fmix32_int, _mul32, fingerprint, fmix32
from .quotient_filter import INT32_MAX, UINT32_MAX, _pad_sort, pack, resolve_device

_GOLD1 = 0x9E3779B9
_GOLD2 = 0x85EBCA77
_MUL1 = 0xC2B2AE3D
_MUL2 = 0x27D4EB2F

#: construction retries (fresh hash seed each) before giving up
MAX_PEEL_ATTEMPTS = 32
#: most peel rounds run between two host reads of the alive count
PEEL_SYNC_EVERY = 32

#: totals over every freeze in this process: freezes run, seeds tried,
#: rounds of the seeds that peeled, and host reads (callers read the deltas)
peel_counts = {"freezes": 0, "attempts": 0, "rounds": 0, "host_syncs": 0}


def canonical_split(p: int) -> tuple[int, int]:
    """The (q, r) split every cross-level fingerprint stream is carried in.

    Any level's (q, r) split of the same p re-quotients to this one
    losslessly (``quotient_filter._requotient``).
    """
    if not (2 <= p <= 62):
        raise ValueError(f"fingerprint bits p must be in [2, 62], got {p}")
    r = min(32, p - 1)
    return p - r, r


class FuseConfig(NamedTuple):
    """Static binary-fuse geometry (hashable)."""

    p: int  # input fingerprint bits (shared with the QF families)
    fp_bits: int  # stored cell width f: fp rate ~= 2**-f
    segment_length: int  # power of two
    segment_count: int  # >= 1 (arbitrary; start picked by mulhi)
    capacity: int  # max multiset size (run storage length)
    seed: int = 0  # key->fingerprint seed (matches the QF families)

    @property
    def slots(self) -> int:
        return (self.segment_count + 2) * self.segment_length

    @property
    def size_bytes(self) -> int:
        """Modeled probe-structure size: fp_bits per cell."""
        return (self.slots * self.fp_bits + 7) // 8

    @property
    def run_bytes(self) -> int:
        """Modeled retained-run size: p bits per stored fingerprint."""
        return (self.capacity * self.p + 7) // 8

    @property
    def canon(self) -> tuple[int, int]:
        return canonical_split(self.p)


def make_config(
    capacity: int,
    p: int,
    fp_bits: int | None = None,
    seed: int = 0,
    segment_length: int | None = None,
) -> FuseConfig:
    """Size a fuse table for ``capacity`` keys via the cost-model geometry."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    canonical_split(p)  # validates p
    L = segment_length or cost_model.fuse_segment_length(capacity)
    if L & (L - 1) or L < 2:
        raise ValueError("segment_length must be a power of two >= 2")
    C = cost_model.fuse_segment_count(capacity, L)
    if C >= 1 << 15:
        raise ValueError("segment_count too large for the 32-bit start mix")
    if fp_bits is None:
        fp_bits = cost_model.fuse_fp_bits_for(min(32, p - 1))
    if not (1 <= fp_bits <= 28):
        raise ValueError(f"fp_bits must be in [1, 28], got {fp_bits}")
    return FuseConfig(
        p=p,
        fp_bits=fp_bits,
        segment_length=L,
        segment_count=C,
        capacity=capacity,
        seed=seed,
    )


class FuseState(NamedTuple):
    """State of one frozen level; the leaves of the reference's pytree."""

    table: torch.Tensor  # int32 (slots,), the uint32 cells' bit pattern
    run_q: torch.Tensor  # int64 (capacity,) canonical quotients, sorted
    run_r: torch.Tensor  # int64 (capacity,) canonical remainders
    n: torch.Tensor  # int32 scalar, multiset size
    n_unique: torch.Tensor  # int32 scalar
    fuse_seed: torch.Tensor  # int32 scalar, the construction seed that peeled
    overflow: torch.Tensor  # bool scalar (capacity exceeded, or no seed peeled)


def _scalars(device, n, n_unique, fuse_seed, overflow):
    """The host numbers of a frozen level as its scalar leaves, filled in on
    ``device`` (no copy from the host)."""
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=device)
    return i32(n), i32(n_unique), i32(fuse_seed), torch.full((), overflow, device=device)


def empty(cfg: FuseConfig, device=None) -> FuseState:
    device = resolve_device(device)
    return FuseState(
        torch.zeros(cfg.slots, dtype=torch.int32, device=device),
        torch.full((cfg.capacity,), INT32_MAX, dtype=torch.int64, device=device),
        torch.full((cfg.capacity,), UINT32_MAX, dtype=torch.int64, device=device),
        *_scalars(device, 0, 0, 0, False),
    )


# ---------------------------------------------------------------------------
# Hashing: canonical fingerprint -> (3 cell positions, stored fp)
# ---------------------------------------------------------------------------


def _mulhi_seg(x: torch.Tensor, m: int) -> torch.Tensor:
    """floor(x * m / 2**32) as the reference computes it, for m < 2**15."""
    lo = (x & 0xFFFF) * m
    hi = (x >> 16) * m
    return (hi + (lo >> 16)) >> 16


def _seed_words(fuse_seed):
    """The two seed-derived words of :func:`fuse_hash` (host ints or tensors)."""
    if isinstance(fuse_seed, torch.Tensor):
        s = fuse_seed.to(torch.int64) & M32
        return fmix32(s ^ _GOLD1), fmix32((s + _GOLD2) & M32)
    s = operator.index(fuse_seed) & M32
    return _fmix32_int(s ^ _GOLD1), _fmix32_int((s + _GOLD2) & M32)


def fuse_hash(cfg: FuseConfig, fq, fr, fuse_seed):
    """Canonical-split fingerprints -> int64 ``(pos0, pos1, pos2, fp)``.

    Positions are cells in three consecutive segments ``start ..
    start+2``; ``fuse_seed`` is a host int or a scalar tensor.  Every
    word is an int64 holding a uint32, as in :mod:`.fingerprint`.
    """
    L = cfg.segment_length
    sa, sb = _seed_words(fuse_seed)
    a = fmix32((fq.to(torch.int64) & M32) ^ sa)
    b = fmix32((fr.to(torch.int64) & M32) ^ sb)
    h1 = fmix32(a ^ _mul32(b, _MUL1))
    h2 = fmix32((b + _mul32(a, _MUL2)) & M32)
    h3 = fmix32(h1 ^ _mul32(h2, _MUL1))
    h4 = fmix32(h2 ^ _mul32(h3, _MUL2))

    start = _mulhi_seg(h1, cfg.segment_count)
    p0 = start * L + (h2 & (L - 1))
    p1 = (start + 1) * L + ((h2 >> 16) & (L - 1))
    p2 = (start + 2) * L + (h3 & (L - 1))
    return p0, p1, p2, h4 >> (32 - cfg.fp_bits)


def key_fingerprints(cfg: FuseConfig, keys: torch.Tensor):
    """Keys -> canonical-split fingerprints (same hash as the QF families)."""
    qc, rc = cfg.canon
    return fingerprint(keys, qc, rc, cfg.seed)


# ---------------------------------------------------------------------------
# Construction: parallel peel + reverse-round replay
# ---------------------------------------------------------------------------


def _fit_plane(x: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """Slice/pad an int64 stream plane to exactly ``cap`` lanes."""
    x = x.to(torch.int64)[:cap]
    pad = cap - x.shape[0]
    if pad > 0:
        x = torch.cat([x, torch.full((pad,), fill, dtype=torch.int64, device=x.device)])
    return x


def _peel(deg: torch.Tensor, pos: torch.Tensor):
    """Peel the hypergraph whose cells ``pos`` (3, n) hold degrees ``deg``.

    Returns ``(ok, round_of, cell_of)``: each key's peel round and the
    cell it is assigned (the first of its cells of degree 1, in the
    reference's order p0, p1, p2); ``ok`` False means a 2-core is left.
    Sync intervals grow 1, 2, 4, ... up to :data:`PEEL_SYNC_EVERY`
    rounds, so that the keys left are compacted early, while most peel.
    """
    dev = pos.device
    n = pos.shape[1]
    round_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cell_of = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    apos = pos
    rnd, every = 0, 1
    while True:
        m = alive.shape[0]
        live = torch.ones(m, dtype=torch.bool, device=dev)
        r_loc = torch.full((m,), -1, dtype=torch.int64, device=dev)
        c_loc = torch.zeros(m, dtype=torch.int64, device=dev)
        for _ in range(every):
            single = deg[apos] == 1
            can = live & single.any(0)
            cell = torch.where(
                single[0], apos[0], torch.where(single[1], apos[1], apos[2])
            )
            r_loc = torch.where(can, rnd, r_loc)
            c_loc = torch.where(can, cell, c_loc)
            deg.index_add_(0, apos.reshape(-1), (-can.to(torch.int32)).repeat(3))
            live = live & ~can
            rnd += 1
        round_of[alive] = r_loc
        cell_of[alive] = c_loc
        alive, apos = alive[live], apos[:, live]  # the host read
        peel_counts["host_syncs"] += 1
        if alive.shape[0] == 0:
            return True, round_of, cell_of
        if alive.shape[0] == m:  # no key peeled since the last read
            return False, round_of, cell_of
        every = min(2 * every, PEEL_SYNC_EVERY)


def _peel_assign(cfg: FuseConfig, pos: torch.Tensor, fp: torch.Tensor):
    """Peel one seed's hypergraph and replay the table assignment.

    ``pos`` is int64 (3, n) cell positions of the n distinct keys and
    ``fp`` their int32 cell values.  Returns ``(ok, table)``: ``ok``
    False means this seed has a 2-core, and the table is then all zero.
    Within a round the assigned cells are disjoint from the cells any
    same-round key reads (a degree-1 cell is incident to exactly one
    alive key), so each round is one gather, xor and scatter.
    """
    dev = pos.device
    table = torch.zeros(cfg.slots, dtype=torch.int32, device=dev)
    deg = torch.zeros(cfg.slots, dtype=torch.int32, device=dev)
    flat = pos.reshape(-1)
    deg.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    ok, round_of, cell_of = _peel(deg, pos)
    if not ok:
        return False, table
    counts = torch.bincount(round_of).tolist()  # keys per round, read once
    peel_counts["host_syncs"] += 1
    peel_counts["rounds"] += len(counts)
    order = torch.argsort(round_of, stable=True)
    pos, fp, cell_of = pos[:, order], fp[order], cell_of[order]
    end = pos.shape[1]
    for c in reversed(counts):
        s = slice(end - c, end)
        g = table[pos[:, s]]
        table[cell_of[s]] = fp[s] ^ g[0] ^ g[1] ^ g[2]
        end -= c
    return True, table


def freeze_stream(
    cfg: FuseConfig, fq, fr, n, max_attempts: int = MAX_PEEL_ATTEMPTS
) -> FuseState:
    """Build a frozen filter from a sorted canonical fingerprint stream.

    ``(fq, fr)`` follow the extract/_pad_sort convention: the first
    ``n`` entries are the sorted multiset, padding is sentinels.  ``n``
    may be a scalar tensor (read to the host once).  A stream longer
    than ``cfg.capacity``, or a 2-core that survives every retry, sets
    ``overflow`` instead of raising, as in the reference.
    """
    nq = _fit_plane(fq, cfg.capacity, INT32_MAX)
    nr = _fit_plane(fr, cfg.capacity, UINT32_MAX)
    dev = nq.device
    n_in = int(n)
    peel_counts["host_syncs"] += 1
    n = min(n_in, cfg.capacity)
    valid = torch.arange(cfg.capacity, device=dev) < n
    nq = torch.where(valid, nq, INT32_MAX)
    nr = torch.where(valid, nr, UINT32_MAX)

    # dedup: identical p-bit fingerprints are one hyperedge (membership
    # is identical; the run keeps the multiset for merges and stats)
    key = pack(nq, nr)
    first = torch.ones(cfg.capacity, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    uniq = torch.nonzero(valid & first).squeeze(1)
    peel_counts["host_syncs"] += 1
    nu = uniq.shape[0]
    uq, ur = nq[uniq], nr[uniq]

    # retry schedule: a fresh hash seed per attempt until the graph peels
    base = (cfg.seed * 0x9E3779B1) & M32
    table = torch.zeros(cfg.slots, dtype=torch.int32, device=dev)
    ok, fuse_seed, attempt = nu == 0, 0, 0
    peel_counts["freezes"] += 1
    while not ok and attempt < max_attempts:
        fuse_seed = ((base + attempt * 0x85EBCA6B) & M32) & 0x7FFFFFFF
        p0, p1, p2, fp = fuse_hash(cfg, uq, ur, fuse_seed)
        ok, table = _peel_assign(cfg, torch.stack([p0, p1, p2]), fp.to(torch.int32))
        attempt += 1
    peel_counts["attempts"] += attempt
    return FuseState(
        table, nq, nr, *_scalars(dev, n, nu, fuse_seed, n_in > cfg.capacity or not ok)
    )


def freeze(cfg: FuseConfig, fq, fr, n, max_attempts: int = MAX_PEEL_ATTEMPTS):
    """Host entry point: :func:`freeze_stream` that raises on capacity overflow."""
    n = operator.index(n)
    if n > cfg.capacity:
        raise ValueError(
            f"stream of {n} fingerprints exceeds frozen capacity "
            f"{cfg.capacity}; grow/resize the level first"
        )
    return freeze_stream(cfg, fq, fr, n, max_attempts)


def freeze_keys(cfg: FuseConfig, keys: torch.Tensor) -> FuseState:
    """Freeze a raw key batch (standalone construction path)."""
    if keys.shape[0] > cfg.capacity:
        raise ValueError(
            f"stream of {keys.shape[0]} fingerprints exceeds frozen capacity "
            f"{cfg.capacity}; grow/resize the level first"
        )
    fq, fr = key_fingerprints(cfg, keys)
    fq, fr = _pad_sort(fq, fr, torch.ones_like(fq, dtype=torch.bool))
    return freeze_stream(cfg, fq, fr, keys.shape[0])


# ---------------------------------------------------------------------------
# Probe (plain path; the kernel path is repro_torch.kernels.ops)
# ---------------------------------------------------------------------------


def lookup_fp(cfg: FuseConfig, state: FuseState, fq, fr) -> torch.Tensor:
    """MAY-CONTAIN for canonical-split fingerprints: 3 gathers + xor."""
    p0, p1, p2, fp = fuse_hash(cfg, fq, fr, state.fuse_seed)
    t = state.table
    got = (t[p0] ^ t[p1] ^ t[p2]).to(torch.int64)
    return (state.n > 0) & (got == fp)


def contains(cfg: FuseConfig, state: FuseState, keys: torch.Tensor) -> torch.Tensor:
    fq, fr = key_fingerprints(cfg, keys)
    return lookup_fp(cfg, state, fq, fr)


def extract_run(cfg: FuseConfig, state: FuseState):
    """The stored sorted run: ``(fq, fr, n)`` in the canonical split."""
    return state.run_q, state.run_r, state.n
