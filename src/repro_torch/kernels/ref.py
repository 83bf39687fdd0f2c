"""PyTorch ports of the JAX package's kernel oracles (``repro.kernels.ref``).

Deliberately independent of ``repro_torch.core`` so that kernel-vs-ref
is a genuine cross-check.  Each takes the same arguments as its JAX
original: planes as int32 (rem: the uint32 bit pattern) or bool, fq/fr
as integer tensors.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _drop_scatter(t: int, idx, values, dtype) -> torch.Tensor:
    """``zeros(t).at[idx].set(values, mode="drop")``."""
    out = torch.zeros(t + 1, dtype=dtype, device=idx.device)
    out[torch.where((idx >= 0) & (idx < t), idx, t)] = values.to(dtype)
    return out[:t]


def build_ref(total_slots: int, pos, fq, fr, con_bits, shf_bits):
    """Scatter sorted items into slot planes.

    pos: strictly increasing probe positions (INT32_MAX for padding),
    fq: bucket ids, fr: remainders (int32 bit pattern), con/shf:
    per-item metadata bits.  Returns int32 (rem, meta, occ) with
    meta = con | shf << 1.
    """
    t = total_slots
    meta = con_bits.to(torch.int32) | (shf_bits.to(torch.int32) << 1)
    rem = _drop_scatter(t, pos, fr, torch.int32)
    meta = _drop_scatter(t, pos, meta, torch.int32)
    occ = _drop_scatter(t, fq, torch.ones_like(fq), torch.int32)
    return rem, meta, occ


def probe_ref(rem, occ, shf, con, fq, fr, window: int):
    """Windowed cluster-decode membership (paper Fig. 3, vectorized).

    Returns (present bool (B,), overflow bool (B,)).
    """
    t = rem.shape[0]
    W = window
    js = torch.arange(2 * W, device=fq.device)
    idx = (fq.to(torch.int64) - W)[:, None] + js[None, :]
    valid = (idx >= 0) & (idx < t)
    idxc = idx.clamp(0, t - 1)

    w_occ = (occ[idxc] > 0) & valid
    w_shf = (shf[idxc] > 0) & valid
    w_con = (con[idxc] > 0) & valid
    w_rem = torch.where(valid, rem[idxc], 0)
    nonempty = w_occ | w_shf

    occ_q = w_occ[:, W]
    upto_q = (js <= W)[None, :]
    b = torch.where(~w_shf & upto_q, js[None, :], -1).max(1).values
    ovf_left = b < 0

    R = (w_occ & (js[None, :] >= b[:, None]) & upto_q).sum(1)

    cum = torch.cumsum(nonempty & ~w_con, 1)
    before = cum.gather(1, (b - 1).clamp(min=0)[:, None])[:, 0]
    C = torch.where(b > 0, before, 0) + R

    in_run = (cum == C[:, None]) & nonempty
    fr32 = fr.to(torch.int32)[:, None]
    present = occ_q & (in_run & (w_rem == fr32)).any(1)
    ovf_right = in_run[:, -1]
    ovf_nostart = occ_q & ~ovf_left & (cum[:, -1] < C)
    overflow = occ_q & (ovf_left | ovf_right | ovf_nostart)
    return present, overflow


def cascade_probe_ref(level_planes, fq_levels, fr_levels, window: int):
    """Multi-level cascade probe oracle: per-level windowed decode
    composed into (hit, ovf) int32 bitmasks (bit l = level l)."""
    B = fq_levels[0].shape[0]
    hit = torch.zeros(B, dtype=torch.int32, device=fq_levels[0].device)
    ovf = torch.zeros_like(hit)
    for lvl, (rem, occ, shf, con) in enumerate(level_planes):
        p, o = probe_ref(rem, occ, shf, con, fq_levels[lvl], fr_levels[lvl], window)
        hit = hit | (p.to(torch.int32) << lvl)
        ovf = ovf | (o.to(torch.int32) << lvl)
    return hit, ovf


def fuse_probe_ref(table, p0, p1, p2, fp):
    """Binary-fuse membership oracle: three gathers + xor + compare.

    table: (slots,) cells; p0/p1/p2: (B,) cell positions (already
    hashed, one per consecutive segment); fp: (B,) stored fingerprints.
    Returns present bool (B,).  The caller owns the empty-table guard.
    """
    t = table.to(torch.int64)
    got = t[p0.to(torch.int64)] ^ t[p1.to(torch.int64)] ^ t[p2.to(torch.int64)]
    return got == fp.to(torch.int64)


def bloom_probe_ref(cells, idx):
    """Blocked-Bloom membership oracle: AND of k direct gathers.

    cells: (ncells,) cell plane (any integer type); idx: int32 (B, k)
    cell indices.  Returns present bool (B,).
    """
    return (cells[idx.to(torch.int64)] != 0).all(1)


def bloom_count_ref(idx_flat, ncells: int):
    """Per-cell increment counts from flat cell indices.

    Sentinel / out-of-range indices (e.g. INT32_MAX for masked keys)
    contribute nothing.  Returns int32 (ncells,).
    """
    t = ncells
    out = torch.zeros(t + 1, dtype=torch.int32, device=idx_flat.device)
    idx = torch.where((idx_flat >= 0) & (idx_flat < t), idx_flat.to(torch.int64), t)
    out.index_put_((idx,), torch.ones_like(idx, dtype=torch.int32), accumulate=True)
    return out[:t]
