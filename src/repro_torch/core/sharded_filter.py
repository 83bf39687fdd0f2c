"""Quotient filter sharded by quotient prefix (the paper's §6 multi-disk
future work, realised as a multi-device AMQ), in PyTorch.

The port of ``repro.core.sharded_filter``.  The fingerprint space is
partitioned by quotient prefix: shard ``s = f_q >> (q - log2(n_shards))``
owns bucket range ``[s·m/n, (s+1)·m/n)``.  Inserts and lookups route
keys to their owner through a fixed-capacity exchange (the
MoE-dispatch pattern), then run the *local* bulk QF ops unchanged:
a shard's keys form one contiguous quotient range.

The JAX package runs this on one controller over a device mesh, with
``shard_map`` and one ``all_to_all(..., tiled=True)`` each way.  The
port mirrors that in one process: the state is a tuple of per-shard
:class:`~.quotient_filter.QFState`, each on its shard's device, and the
exchange is a copy of every source's bucket ``d`` to shard ``d``'s
device (none at all where two shards share a device).  The local passes
are arguments, so the caller picks the kernel path or the plain one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import quotient_filter as qf


def _dispatch_capacity(cfg: "ShardedQFConfig", per_shard: int) -> int:
    """Per-(src, dst) bucket capacity for the fixed-size exchange.

    A source shard holding ``per_shard`` keys routes ~per_shard/n_shards
    to each owner; sizing is mean + capacity_factor standard deviations
    of the Binomial(per_shard, 1/n) tail (ceil, min 8, multiple of 8) so
    skewed routing does not silently drop keys.
    """
    mean = per_shard / cfg.n_shards
    std = math.sqrt(per_shard * (1 / cfg.n_shards) * (1 - 1 / cfg.n_shards))
    capacity = int(math.ceil(mean + max(6.0, cfg.capacity_factor) * std))
    capacity = max(8, capacity)
    return capacity + (-capacity) % 8


class ShardedQFConfig(NamedTuple):
    q: int  # global log2 buckets
    r: int
    n_shards: int
    axis: str = "data"
    seed: int = 0
    capacity_factor: float = 2.0

    @property
    def shard_bits(self) -> int:
        return int(math.log2(self.n_shards))

    @property
    def local_cfg(self) -> qf.QFConfig:
        # the local remainder keeps the full fingerprint width, so the
        # shard id and the local (q, r) reconstruct the global fingerprint
        return qf.QFConfig(
            q=self.q - self.shard_bits, r=self.r + self.shard_bits, seed=self.seed
        )


def empty(cfg: ShardedQFConfig, devices) -> tuple:
    """Per-shard empty states, shard ``s`` on ``devices[s]``."""
    return tuple(qf.empty(cfg.local_cfg, d) for d in devices)


def devices_of(state) -> list:
    return [s.rem.device for s in state]


def _route(cfg: ShardedQFConfig, keys, fingerprints):
    """Owner shard + local fingerprint for each key.

    The JAX package's ``valid`` argument is all true at both of its call
    sites, so every owner here is a shard.
    """
    fq, fr = fingerprints(qf.QFConfig(q=cfg.q, r=cfg.r, seed=cfg.seed), keys)
    owner = fq >> (cfg.q - cfg.shard_bits)
    # local quotient drops the shard prefix; remainder keeps width
    local_q = fq & ((1 << (cfg.q - cfg.shard_bits)) - 1)
    return owner, local_q, fr


def _dispatch(owner, payload, n_shards: int, capacity: int):
    """Bucket payload rows by owner with per-shard capacity (drop excess).

    Returns ``(buckets, valid, order, slot)``: each payload tensor as
    ``(n_shards, capacity)`` buckets, their ``(n_shards, capacity)``
    validity, the stable order by owner and each sorted row's flat
    bucket slot (``n_shards * capacity`` for a dropped row).  Which rows
    drop is the reference's: the first ``capacity`` rows of each owner in
    batch order keep their place.
    """
    B = owner.shape[0]
    dev = owner.device
    so, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(so, torch.arange(n_shards, device=dev))
    rank = torch.arange(B, device=dev) - start[so]
    keep = rank < capacity
    dump = n_shards * capacity  # one slot past the buckets, cut off below
    slot = torch.where(keep, so * capacity + rank, dump)

    def scat(x_sorted):
        out = torch.zeros(dump + 1, dtype=x_sorted.dtype, device=dev)
        out[slot] = x_sorted
        return out[:dump].reshape(n_shards, capacity)

    buckets = tuple(scat(x[order]) for x in payload)
    return buckets, scat(keep), order, slot


def _split(cfg: ShardedQFConfig, keys, devices) -> list:
    """The batch's equal slices, slice ``s`` on shard ``s``'s device."""
    per_shard = keys.shape[0] // cfg.n_shards
    return [
        keys[s * per_shard : (s + 1) * per_shard].to(d, non_blocking=True)
        for s, d in enumerate(devices)
    ]


def exchange(rows, devices) -> list:
    """The tiled all_to_all: ``rows[s]`` is source ``s``'s ``(n_dst, ...)``
    tensor; destination ``d`` receives every source's row ``d`` on
    ``devices[d]``, concatenated in source order."""
    return [
        torch.cat([src[d].to(dev, non_blocking=True) for src in rows])
        for d, dev in enumerate(devices)
    ]


def route_and_bucket(cfg: ShardedQFConfig, state, keys, fingerprints) -> list:
    """Each source routes and buckets its own slice of ``keys``.

    Returns, per source, ``(local_q, fr, valid, order, slot)`` with the
    first three as ``(n_dst, capacity)`` buckets.
    """
    devices = devices_of(state)
    capacity = _dispatch_capacity(cfg, keys.shape[0] // cfg.n_shards)
    out = []
    for keys_local in _split(cfg, keys, devices):
        owner, lq, fr = _route(cfg, keys_local, fingerprints)
        (bq, bfr), bvalid, order, slot = _dispatch(
            owner, (lq, fr), cfg.n_shards, capacity
        )
        out.append((bq, bfr, bvalid, order, slot))
    return out


def insert_local(cfg: ShardedQFConfig, state, received, insert_fingerprints) -> tuple:
    """Every shard merges the rows it received: ``received`` is
    :func:`exchange`'s ``(local_q, fr, valid)``, one per destination."""
    local = cfg.local_cfg
    return tuple(
        insert_fingerprints(local, st, fq, fr, valid)
        for st, fq, fr, valid in zip(state, *received)
    )


def insert(cfg: ShardedQFConfig, state, keys, fingerprints, insert_fingerprints):
    """Sharded bulk insert: ``(state, keys) -> state``.

    ``keys`` splits into ``n_shards`` equal slices, one a shard; each
    source buckets its own slice by owner, one exchange delivers every
    bucket to its owner, and the local bulk QF insert runs unchanged.
    ``fingerprints(qf_cfg, keys) -> (fq, fr)`` hashes a slice,
    ``insert_fingerprints(qf_cfg, state, fq, fr, valid)`` merges a
    validity-masked batch into one shard.
    """
    buckets = route_and_bucket(cfg, state, keys, fingerprints)
    devices = devices_of(state)
    received = [exchange([b[i] for b in buckets], devices) for i in range(3)]
    return insert_local(cfg, state, received, insert_fingerprints)


def lookup_local(cfg: ShardedQFConfig, state, received, lookup_fingerprints) -> list:
    """Every shard answers the queries it received (:func:`exchange`'s
    ``(local_q, fr)``, one per destination): ``(n_src, capacity)`` hits."""
    local = cfg.local_cfg
    return [
        lookup_fingerprints(local, st, fq, fr).reshape(cfg.n_shards, -1)
        for st, fq, fr in zip(state, *received)
    ]


def answers(hits, buckets, devices):
    """The hits travel back to their sources the way the queries came,
    and each source gathers its rows by ``slot``: ``present (B,)`` on
    shard 0's device."""
    out = []
    for flat, (_, _, _, order, slot) in zip(exchange(hits, devices), buckets):
        n = flat.shape[0]
        out_sorted = (slot < n) & flat[slot.clamp(max=n - 1)]
        present = torch.zeros(order.shape[0], dtype=torch.bool, device=flat.device)
        present[order] = out_sorted
        out.append(present.to(devices[0], non_blocking=True))
    return torch.cat(out)


def lookup(cfg: ShardedQFConfig, state, keys, fingerprints, lookup_fingerprints):
    """Sharded lookup: ``(state, keys) -> present (B,)`` on shard 0's device.

    ``lookup_fingerprints(qf_cfg, state, fq, fr)`` answers one shard's
    queries.
    """
    devices = devices_of(state)
    buckets = route_and_bucket(cfg, state, keys, fingerprints)
    received = [exchange([b[i] for b in buckets], devices) for i in range(2)]
    hits = lookup_local(cfg, state, received, lookup_fingerprints)
    return answers(hits, buckets, devices)
