"""Kernel-path wrappers binding the CUDA kernels to the filter states.

The port of the wrappers of ``repro.kernels.ops``: ``build_sorted``,
``extract`` (the decode, XLA code in the JAX package),
``build_span``/``build_chunk`` (the incremental migration's append),
``lookup``/``contains``, ``fuse_lookup``/``fuse_contains``,
``cascade_lookup``, and the Bloom families' ``bloom_counts`` and
``bloom_probe``.  Each runs its kernel for CUDA state and the kernel's
plain PyTorch version for CPU state (:mod:`.dispatch`), and each
returns exactly what the plain path of ``repro_torch.core`` returns.

The JAX wrappers settled window overflows with a ``lax.cond`` on
``any(ovf)``; here the QF probe kernels walk whole clusters and the
fuse probe gathers its three cells directly, so there is nothing to
settle and no host sync on a probe.  The Bloom kernels take
indices in any order, so the JAX wrappers' sorts, un-permutes and
overflow recounts have no counterpart either.  The JAX wrappers jit the
key hash with each probe; here keys become int32 fingerprint pairs in
one ``fingerprint`` launch, which the probe kernels take as they are,
and the fuse probe hashes those pairs to cell positions itself.  Where
a caller hands in the int64 streams of ``core``, the wrappers narrow
them to int32, as the TPU kernels took them; the span append reads
them as they are.  No kernel-path build calls ``torch.cummax``: the
probe positions come from the ``qf_positions`` scan, or from inside
``qf_build_span``.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core import fuse_filter as ffc
from ..core import quotient_filter as qf
from . import bloom_block
from .cascade_probe import cascade_probe
from .fingerprint import fingerprint
from .fuse_probe import fuse_probe
from .qf_build import qf_build_planes, qf_build_span, qf_positions
from .qf_decode import qf_decode
from .qf_probe import qf_probe


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to int32, keeping the low 32 bits (uint32 bit patterns)."""
    return x.to(torch.int32)


def build_sorted(cfg: qf.QFConfig, fq, fr, n) -> qf.QFState:
    """Kernel-path equivalent of ``quotient_filter.build_sorted``.

    The streams narrowed to int32 once, the probe positions by the
    ``qf_positions`` scan, the planes by the ``qf_build_planes`` kernel.
    """
    if cfg.r > 31:
        raise ValueError("kernel path keeps the JAX package's r <= 31 limit")
    with tracing.span("qf.build"):
        nn = qf._i32(n, fq.device)
        fq, fr = _i32(fq), _i32(fr)
        # a position past INT32_MAX wraps negative and is dropped, as one past
        # the last slot is
        pos, overflow = qf_positions(fq, nn, cfg.total_slots)
        rem, occ, shf, con = qf_build_planes(pos, fq, fr, nn, cfg.total_slots)
        return qf.QFState(rem=rem, occ=occ, shf=shf, con=con, n=nn, overflow=overflow)


def extract(cfg: qf.QFConfig, state: qf.QFState):
    """Kernel-path equivalent of ``quotient_filter.extract``: the planes
    decoded by ``qf_decode``, ``(fq, fr, n)`` with the int64 streams of
    ``core``."""
    with tracing.span("qf.extract"):
        fq, fr = qf_decode(state.rem, state.occ, state.shf, state.con)
    return fq, fr, state.n


def build_span(cfg: qf.QFConfig, state: qf.QFState, fq, fr, k, last_pos, last_fq):
    """Append a sorted span (first ``k`` rows valid) to a partly built QF.

    ``state`` holds exactly the entries appended so far, in sorted
    order; ``(last_pos, last_fq)`` (int32 scalar tensors, both -1 before
    the first span) carry the probe scan across calls, and every valid
    fingerprint sorts at or after ``last_fq``.  Appending span by span
    reproduces ``quotient_filter.build_sorted`` of the whole prefix bit
    for bit: the scan ``pos[i] = max(pos[i-1] + 1, fq[i])`` closes to
    ``i + max(last_pos + 1, cummax(fq - i))`` over any span length.
    ``fq``/``fr`` are the int64 streams of ``core``; ``k`` an int or an
    int32 scalar tensor.

    One ``qf_build_span`` launch (its plain version for CPU state) scans
    the span, writes the planes of ``state`` in place and advances ``n``,
    ``overflow`` and the carries, with no host read, so the argument's
    planes are consumed: use the returned state, as a caller of the JAX
    package's donated migration step must.  Returns
    ``(state, last_pos, last_fq)``.
    """
    if cfg.r > 31:
        raise ValueError("kernel path keeps the JAX package's r <= 31 limit")
    kk = qf._i32(k, fq.device)
    n, overflow, last_pos, last_fq = qf_build_span(
        fq, fr, kk, state.n, state.overflow, last_pos, last_fq,
        state.rem, state.occ, state.shf, state.con,
    )
    return state._replace(n=n, overflow=overflow), last_pos, last_fq


def build_chunk(cfg: qf.QFConfig, state: qf.QFState, fq, fr, k, last_pos, last_fq):
    """The per-insert migration step: :func:`build_span` of one chunk.

    The JAX package scatters a chunk and runs its TPU kernel for longer
    spans; both compute the same planes, and here both are one
    ``qf_build_span`` launch, O(chunk).
    """
    return build_span(cfg, state, fq, fr, k, last_pos, last_fq)


def lookup(cfg: qf.QFConfig, state: qf.QFState, fq, fr) -> torch.Tensor:
    """MAY-CONTAIN for fingerprints, equal to ``quotient_filter.lookup_exact``."""
    return qf_probe(state.rem, state.occ, state.shf, state.con, _i32(fq), _i32(fr))


def contains(cfg: qf.QFConfig, state: qf.QFState, keys) -> torch.Tensor:
    fq, fr = fingerprint(keys, cfg.q, cfg.r, cfg.seed, torch.int32)
    return lookup(cfg, state, fq, fr)


def fuse_lookup(cfg: ffc.FuseConfig, state: ffc.FuseState, fq, fr) -> torch.Tensor:
    """Binary-fuse MAY-CONTAIN for canonical fingerprints, equal to
    ``fuse_filter.lookup_fp``: the hash and the three gathers in one
    ``fuse_probe`` launch (queries in any order, no sort, the seed read
    on the card)."""
    hit = fuse_probe(
        state.table, _i32(fq), _i32(fr), state.fuse_seed, cfg.segment_length,
        cfg.segment_count, cfg.fp_bits,
    )
    return (state.n > 0) & hit


def fuse_contains(cfg: ffc.FuseConfig, state: ffc.FuseState, keys) -> torch.Tensor:
    qc, rc = cfg.canon
    fq, fr = fingerprint(keys, qc, rc, cfg.seed, torch.int32)
    return fuse_lookup(cfg, state, fq, fr)


def cascade_lookup(qf_cfgs, qf_states, fuse_cfgs, fuse_states, keys):
    """Probe a whole cascade stack: one fused launch over its quotient
    filters, one ``fuse_probe`` launch per frozen level.

    ``qf_cfgs``/``qf_states`` are the unfrozen structures top-down (Q0
    first), ``fuse_cfgs``/``fuse_states`` the frozen levels; all must
    share the fingerprint width ``p`` and seed.  Keys are hashed once in
    the canonical split (one ``fingerprint`` launch), which the QF kernel
    re-splits for each level (requotienting is a bit move, so the
    fingerprint is the same) and the frozen levels hash as they are.
    Returns one bool (B,) hit array per structure, QF structures first,
    in argument order.
    """
    p = qf_cfgs[0].q + qf_cfgs[0].r
    seed = qf_cfgs[0].seed
    for c in qf_cfgs:
        if c.q + c.r != p or c.seed != seed:
            raise ValueError("cascade levels must share fingerprint bits and seed")
    for c in fuse_cfgs:
        if c.p != p or c.seed != seed:
            raise ValueError("frozen levels must share fingerprint bits and seed")
    qc, rc = ffc.canonical_split(p)
    fqc, frc = fingerprint(keys, qc, rc, seed, torch.int32)
    hitm = cascade_probe(
        [(s.rem, s.occ, s.shf, s.con) for s in qf_states],
        [s.n for s in qf_states],  # an empty level answers no, unread
        [c.r for c in qf_cfgs],
        fqc,
        frc,
        rc,
    )
    with tracing.span("kernels.unpack"):
        qf_hits = tuple(((hitm >> lvl) & 1) > 0 for lvl in range(len(qf_states)))
    return qf_hits + tuple(
        fuse_lookup(c, s, fqc, frc) for c, s in zip(fuse_cfgs, fuse_states)
    )


def bloom_counts(idx_flat, ncells: int) -> torch.Tensor:
    """Aggregate a flat batch of int32 cell indices into an int32 counts plane.

    The Bloom families' write-side primitive: insert is ``cells + counts``
    (counting) or ``cells | (counts > 0)`` (plain), delete is
    ``cells - counts``.  Out-of-range indices (masked keys) drop.
    """
    return bloom_block.bloom_count(idx_flat, ncells)


def bloom_probe(cells, idx) -> torch.Tensor:
    """AND-of-k membership over a cell plane for int32 (B, k) cell indices."""
    return bloom_block.bloom_probe(cells, idx)
