"""Quotient filter sharded by quotient prefix under the functional
protocol (paper §6), in PyTorch.

The port of ``repro.filters.sharded``: an adapter over
:mod:`repro_torch.core.sharded_filter`.  The state is a tuple of
per-shard QF states, and insert/contains route keys to their owner
shard with the MoE-dispatch exchange.  ``merge`` is the per-shard
pairwise QF merge (shard s owns the same quotient range in both
inputs); ``grow`` and ``shrink`` re-split every shard in place and
halve the shard count.  ``delete`` is not registered, as in the
reference.

Devices.  ``make(device=None)`` places shard ``s`` on ``cuda:s`` and
needs ``n_shards`` to divide the card count, as the reference needs it
to divide its device count.  One device (``"cpu"``, ``"cuda:0"``) is a
one-device mesh and holds ``n_shards == 1`` only.  A list of
``n_shards`` devices places shard ``s`` on ``devices[s]``, and a device
may repeat: the counterpart of XLA's forced host device count, and the
way to run eight shards on one card or on the CPU.

Paths.  Shards on the card take the kernel path (the ``fingerprint``
kernel for routing, ``kernels.ops.extract`` for every decode,
``kernels.ops.build_sorted`` for every build, ``kernels.ops.lookup`` for
lookups), shards on the CPU the plain path of
:mod:`repro_torch.core.quotient_filter`.  The spec has no ``backend``
field, as the reference's has none; a local remainder of 32 bits, which
the reference allows, is refused on the card by the kernel path's
``r <= 31`` limit and never falls back to the plain build.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import quotient_filter as qf
from ..core import sharded_filter as sf
from ..kernels import dispatch
from ..kernels import ops as kops
from . import qf_filter
from .registry import FilterImpl, register


class ShardedQFilterConfig(NamedTuple):
    q: int  # global log2 buckets
    r: int
    n_shards: int = 1
    axis: str = "data"
    seed: int = 0
    capacity_factor: float = 2.0
    shrink_load: float = 0.4  # low watermark for shard consolidation

    @property
    def core(self) -> sf.ShardedQFConfig:
        return sf.ShardedQFConfig(
            q=self.q,
            r=self.r,
            n_shards=self.n_shards,
            axis=self.axis,
            seed=self.seed,
            capacity_factor=self.capacity_factor,
        )


def shard_devices(n_shards: int, device=None) -> list:
    """The device of each shard under the family's device rule."""
    if device is None:
        qf.resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        if count % n_shards:
            raise ValueError(f"n_shards={n_shards} does not divide {count} devices")
        return [torch.device("cuda", s) for s in range(n_shards)]
    if isinstance(device, (str, torch.device)):
        if n_shards != 1:
            raise ValueError(
                f"one device holds one shard, not n_shards={n_shards}; pass a "
                "list of n_shards devices (a device may repeat)"
            )
        return [torch.device(device)]
    devices = [torch.device(d) for d in device]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for n_shards={n_shards}")
    if len({d.type == "cuda" for d in devices}) > 1:
        raise ValueError("shards must lie all on the CPU or all on CUDA devices")
    return devices


def _fingerprints(core: qf.QFConfig, keys):
    return qf_filter.fingerprint_fn(dispatch.backend_for(keys.device))(core, keys)


def _build(cfg: qf.QFConfig, fq, fr, n):
    return qf_filter.build_fn(dispatch.backend_for(fq.device))(cfg, fq, fr, n)


def _extract(cfg: qf.QFConfig, state):
    return qf_filter.extract_fn(dispatch.backend_for(state.rem.device))(cfg, state)


def _insert_fingerprints(core: qf.QFConfig, state, fq, fr, valid):
    return qf_filter.insert_fingerprints(
        core, dispatch.backend_for(fq.device), state, fq, fr, valid
    )


def _lookup(core: qf.QFConfig, state, fq, fr):
    if fq.is_cuda:
        return kops.lookup(core, state, fq, fr)
    return qf.lookup(core, state, fq, fr)


def _pad_batch(cfg, keys):
    """Pad to a multiple of n_shards (the exchange needs equal splits)."""
    pad = (-keys.shape[0]) % cfg.n_shards
    if pad:
        keys = torch.cat([keys, keys[:1].repeat(pad)])
    return keys, pad


def _counts(state):
    """Every shard's count, on shard 0's device (no host read)."""
    dev = state[0].n.device
    return torch.stack([s.n.to(dev, non_blocking=True) for s in state])


def _to(state: qf.QFState, device) -> qf.QFState:
    return qf.QFState(*(x.to(device, non_blocking=True) for x in state))


def make(device=None, **spec):
    cfg = ShardedQFilterConfig(**spec)
    if cfg.n_shards < 1 or cfg.n_shards & (cfg.n_shards - 1):
        raise ValueError("n_shards must be a power of two")
    return cfg, sf.empty(cfg.core, shard_devices(cfg.n_shards, device))


def insert(cfg: ShardedQFilterConfig, state, keys, k=None):
    if k is not None:
        raise NotImplementedError("sharded_qf insert does not take a valid count")
    if keys.shape[0] % cfg.n_shards:
        # padding would insert duplicate fingerprints (QF is a multiset)
        raise ValueError(
            f"insert batch ({keys.shape[0]}) must be a multiple of n_shards"
        )
    return sf.insert(cfg.core, state, keys, _fingerprints, _insert_fingerprints)


def contains(cfg: ShardedQFilterConfig, state, keys):
    keys, pad = _pad_batch(cfg, keys)
    hit = sf.lookup(cfg.core, state, keys, _fingerprints, _lookup)
    return hit[: hit.shape[0] - pad] if pad else hit


def merge(cfg: ShardedQFilterConfig, sa, sb):
    local = cfg.core.local_cfg
    return tuple(
        qf.merge(local, local, local, a, _to(b, a.rem.device), build=_build,
                 extract=_extract)
        for a, b in zip(sa, sb)
    )


def needs_resize(cfg: ShardedQFilterConfig, state):
    """Device predicate: global count at the paper's max-load point."""
    return _counts(state).sum() >= cfg.core.local_cfg.capacity * cfg.n_shards


def grow(cfg: ShardedQFilterConfig, state):
    """Per-shard growth: every shard steals one remainder bit, doubling
    the global bucket count while the quotient-prefix shard map is
    untouched (the owner bits are the *top* bits of the quotient).

    The stored local remainders are the global ``r`` real bits (the
    local config only declares the wider ``r + shard_bits`` slot so the
    shard id stays reconstructable), so the requotient must move the
    top bit of the *r-bit* remainder — the width-true split below, not
    ``local_cfg.r``.
    """
    if cfg.r <= 1:
        raise ValueError(
            f"cannot grow: fingerprint bits exhausted (q={cfg.q}, r={cfg.r})"
        )
    new_cfg = cfg._replace(q=cfg.q + 1, r=cfg.r - 1)
    lold, lnew = cfg.core.local_cfg, new_cfg.core.local_cfg
    win = lold._replace(r=cfg.r)
    wout = lnew._replace(r=cfg.r - 1)
    pad = lnew.total_slots - lold.total_slots

    def one(s):
        qs, rs, n = _extract(lold, s)
        qs, rs = qf._requotient(qs, rs, win, wout)
        qs = torch.cat([qs, qs.new_full((pad,), qf.INT32_MAX)])
        rs = torch.cat([rs, rs.new_full((pad,), qf.UINT32_MAX)])
        new = _build(lnew, qs, rs, n)
        return new._replace(overflow=new.overflow | s.overflow)

    return new_cfg, tuple(one(s) for s in state)


def resize(cfg: ShardedQFilterConfig, state, new_q: int):
    """Grow to ``new_q`` global quotient bits (shrinking the *table*
    would need per-slot re-merging across every shard; capacity comes
    back down by consolidating shards instead — see :func:`shrink`)."""
    if new_q < cfg.q:
        raise NotImplementedError(
            "sharded_qf tables only grow (new_q >= q); use shrink() to "
            "consolidate shards when load is low"
        )
    while cfg.q < new_q:
        cfg, state = grow(cfg, state)
    return cfg, state


def _can_halve(cfg: ShardedQFilterConfig) -> bool:
    # halving merges shard pairs AND re-merges one quotient bit into the
    # remainder (the inverse of grow): it needs an even pair count, a
    # surviving local table, and remainder headroom for the returned bit
    return (
        cfg.n_shards >= 2
        and cfg.n_shards % 2 == 0
        and cfg.q - cfg.core.shard_bits >= 2
        and cfg.r + cfg.core.shard_bits <= 32  # declared local width holds
    )


def needs_shrink(cfg: ShardedQFilterConfig, state):
    """Device predicate: the population fits the halved filter (half
    the shards AND half the global buckets) at the low watermark.

    Each shrink halves global capacity, so the threshold halves with
    it — real hysteresis: one quiet period consolidates one step, not
    the whole fleet, and the count must double again before the high
    watermark can trip."""
    if not _can_halve(cfg):
        return torch.zeros((), dtype=torch.bool, device=state[0].n.device)
    halved = cfg._replace(q=cfg.q - 1, r=cfg.r + 1, n_shards=cfg.n_shards // 2)
    cap = halved.core.local_cfg.capacity * halved.n_shards
    return _counts(state).sum() <= int(cfg.shrink_load * cap)


def shrink(cfg: ShardedQFilterConfig, state):
    """Halve the filter: shard pairs redistribute and a quotient bit
    re-merges into the remainder — the exact inverse of ``grow``.

    Dropping the global quotient's low bit sends it to the remainder
    top (paper §3 resizing, run downward), and dropping one owner bit
    hands shards ``2s`` and ``2s + 1`` to the new shard ``s``: after a
    per-shard width-true requotient the owner parity becomes the local
    top bit, so every entry of shard ``2s + 1`` lands exactly one
    half-table above shard ``2s``'s entries.  Both inputs are sorted
    streams with all of ``2s``'s quotients preceding ``2s + 1``'s
    offset quotients, so the redistribution is one sort-free two-stream
    merge + rebuild per pair.  The local table geometry is unchanged;
    the new shard ``s`` lies on old shard ``s``'s device, as the
    reference commits the result onto the halved mesh.
    """
    if not _can_halve(cfg):
        raise ValueError(
            f"cannot halve q={cfg.q}, r={cfg.r}, n_shards={cfg.n_shards}"
        )
    new_cfg = cfg._replace(q=cfg.q - 1, r=cfg.r + 1, n_shards=cfg.n_shards // 2)
    lold, lnew = cfg.core.local_cfg, new_cfg.core.local_cfg
    # same local geometry before and after: one quotient bit moves from
    # the local table to the remainder while one owner bit moves back in
    assert (lnew.q, lnew.r) == (lold.q, lold.r)
    # width-true split: stored remainders carry the global r bits only
    win = lold._replace(r=cfg.r)
    wout = win._replace(q=lold.q - 1, r=cfg.r + 1)
    half = 1 << wout.q  # odd shards' entries take the upper half

    def one(even, odd, dev):
        qe, re_, ne = _extract(lold, even)
        qo, ro, no = _extract(lold, odd)
        qe, re_ = qf._requotient(qe, re_, win, wout)
        qo, ro = qf._requotient(qo, ro, win, wout)
        qo = torch.where(qo == qf.INT32_MAX, qf.INT32_MAX, qo + half)
        qe, re_, ne, qo, ro, no = (
            x.to(dev, non_blocking=True) for x in (qe, re_, ne, qo, ro, no)
        )
        allq, allr = qf.merge_streams(qe, re_, ne, qo, ro, no)
        new = _build(lnew, allq, allr, ne + no)
        overflow = even.overflow.to(dev) | odd.overflow.to(dev)
        return new._replace(overflow=new.overflow | overflow)

    return new_cfg, tuple(
        one(state[2 * s], state[2 * s + 1], state[s].rem.device)
        for s in range(new_cfg.n_shards)
    )


def stats(cfg: ShardedQFilterConfig, state):
    counts = _counts(state)
    n = counts.sum(dtype=torch.int32)
    dev = counts.device
    return {
        "n": n,
        "shard_counts": counts,
        "load": n.to(torch.float32) / (1 << cfg.q),
        "overflow": torch.stack([s.overflow.to(dev) for s in state]).any(),
        "size_bytes": cfg.n_shards * cfg.core.local_cfg.size_bytes,
    }


def stacked(state, device="cpu") -> qf.QFState:
    """The per-shard states as one state of stacked leaves (leading dim
    ``n_shards``) on ``device``: the JAX package's layout."""
    return qf.QFState(
        *(torch.stack([x.to(device) for x in leaf]) for leaf in zip(*state))
    )


def unstacked(stacked_state: qf.QFState, devices) -> tuple:
    """The inverse of :func:`stacked`: shard ``s`` on ``devices[s]``."""
    return tuple(
        qf.QFState(*(x[s].to(d, copy=True) for x in stacked_state))
        for s, d in enumerate(devices)
    )


IMPL = register(
    FilterImpl(
        name="sharded_qf",
        paper_section="§6 (future work: multi-device AMQ, quotient-prefix sharded)",
        cfg_cls=ShardedQFilterConfig,
        make=make,
        insert=insert,
        contains=contains,
        stats=stats,
        merge=merge,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
    )
)
