"""Bulk-parallel quotient filter (the paper's §3), in PyTorch.

The port of ``repro.core.quotient_filter``: the same planes, the same
bulk build (``pos[i] = i + cummax(fq[i] - i)`` over sorted
fingerprints), the same rank/select ``extract`` and the same windowed
``lookup`` with its exact fallback.  Every function here is the plain
PyTorch path: the ``"reference"`` backend of the filters runs it, and
the tests hold it against the JAX package bit for bit.

Representation:

* planes: ``rem`` is int32 holding the uint32 remainder bit pattern;
  ``occ``/``shf``/``con`` are bool; ``n`` is an int32 scalar tensor and
  ``overflow`` a bool scalar tensor;
* fingerprint streams ``(fq, fr)`` are int64 holding the unsigned
  values; padding is ``(INT32_MAX, UINT32_MAX)`` as in the JAX package.
  A lexicographic order of ``(fq, fr)`` is the order of the packed key
  ``(fq << 32) | fr``, so every two-key sort and search is one int64
  sort or ``searchsorted``.

Scatters that JAX writes with ``mode="drop"`` go to one extra dump slot
past the plane's end, which is cut off afterwards: torch raises on an
out-of-range index, and a mask would need the count on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from .fingerprint import M32, fingerprint

INT32_MAX = 2**31 - 1
UINT32_MAX = M32
_SENTINEL_KEY = (INT32_MAX << 32) | UINT32_MAX


class QFConfig(NamedTuple):
    """Static quotient-filter configuration (hashable)."""

    q: int  # log2 number of buckets
    r: int  # remainder bits; false-positive rate ~= load * 2**-r
    slack: int = 1024  # extra slots past 2**q absorbing the last cluster
    seed: int = 0
    max_load: float = 0.75  # paper's recommended operating point

    @property
    def m(self) -> int:
        return 1 << self.q

    @property
    def total_slots(self) -> int:
        return self.m + self.slack

    @property
    def capacity(self) -> int:
        return int(self.m * self.max_load)

    @property
    def bits_per_slot(self) -> int:
        return self.r + 3

    @property
    def size_bytes(self) -> int:
        """Modeled size of the packed structure (r+3 bits per slot)."""
        return (self.total_slots * self.bits_per_slot + 7) // 8


class QFState(NamedTuple):
    """Filter state. Planes have length cfg.total_slots."""

    rem: torch.Tensor  # int32, uint32 bit pattern of the remainders
    occ: torch.Tensor  # bool  is_occupied   (indexed by bucket)
    shf: torch.Tensor  # bool  is_shifted    (indexed by slot)
    con: torch.Tensor  # bool  is_continuation (indexed by slot)
    n: torch.Tensor  # int32 scalar, number of stored fingerprints
    overflow: torch.Tensor  # bool scalar, slack exhausted (should stay False)


def resolve_device(device=None) -> torch.device:
    """The device a constructor puts state on: the card unless asked.

    ``device=None`` means CUDA; without a card that raises rather than
    quietly building on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to build "
                "state on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _i32(x, device) -> torch.Tensor:
    """``x`` as an int32 scalar on ``device``.  A host number is filled in
    there, which copies nothing from the host (``torch.as_tensor`` of a
    Python int would: a synchronizing copy on the card)."""
    if torch.is_tensor(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device)
    return torch.full((), x, dtype=torch.int32, device=device)


def empty(cfg: QFConfig, device=None) -> QFState:
    device = resolve_device(device)
    t = cfg.total_slots
    return QFState(
        rem=torch.zeros(t, dtype=torch.int32, device=device),
        occ=torch.zeros(t, dtype=torch.bool, device=device),
        shf=torch.zeros(t, dtype=torch.bool, device=device),
        con=torch.zeros(t, dtype=torch.bool, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def load(cfg: QFConfig, state: QFState) -> torch.Tensor:
    """Load factor alpha = n / m."""
    return state.n.to(torch.float32) / cfg.m


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def fingerprints(cfg: QFConfig, keys: torch.Tensor):
    """Hash keys to (quotient, remainder) for this filter."""
    return fingerprint(keys, cfg.q, cfg.r, cfg.seed)


def pack(fq: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
    """The int64 key whose order is the lexicographic order of (fq, fr)."""
    return (fq << 32) | fr


def _pad_sort(fq: torch.Tensor, fr: torch.Tensor, valid: torch.Tensor):
    """Sort (fq, fr) lexicographically, pushing invalid entries to the end."""
    key = torch.where(valid, pack(fq, fr), _SENTINEL_KEY)
    key = torch.sort(key).values
    return key >> 32, key & M32


# ---------------------------------------------------------------------------
# Bulk build: sorted fingerprints -> slot planes
# ---------------------------------------------------------------------------


def probe_positions(cfg: QFConfig, fq: torch.Tensor, n):
    """Linear-probe slots of sorted quotients, the first ``n`` valid.

    ``pos[i] = max(pos[i-1] + 1, fq[i]) = i + cummax(fq[i] - i)``.
    Returns ``(nn, valid, pos, overflow)``: ``n`` as an int32 scalar
    tensor, the valid-row mask, the int64 positions, and whether a
    valid row fell past the last slot.
    """
    nn = _i32(n, fq.device)
    idx = torch.arange(fq.shape[0], device=fq.device)
    valid = idx < nn
    d = torch.where(valid, fq - idx, -INT32_MAX)
    pos = idx + torch.cummax(d, 0).values
    overflow = (valid & (pos >= cfg.total_slots)).any()
    return nn, valid, pos, overflow


def build_sorted(cfg: QFConfig, fq: torch.Tensor, fr: torch.Tensor, n) -> QFState:
    """Build a QF from lexicographically sorted (fq, fr), first ``n`` valid.

    Padding entries must sort after all valid ones (fq == INT32_MAX).
    """
    t = cfg.total_slots
    with tracing.span("qf.build"):
        nn, valid, pos, overflow = probe_positions(cfg, fq, n)
        idx = torch.arange(fq.shape[0], device=fq.device)
        con_bits = valid & (idx > 0) & (fq == torch.roll(fq, 1))
        shf_bits = valid & (pos != fq)
        spos = torch.where(valid & (pos < t), pos, t)  # slot t is the dump slot

        def plane(dtype, values):
            out = torch.zeros(t + 1, dtype=dtype, device=fq.device)
            out[spos] = values.to(dtype)
            return out[:t]

        occ = torch.zeros(t + 1, dtype=torch.bool, device=fq.device)
        occ.index_fill_(0, torch.where(valid, fq, t), True)  # a scalar fill copies nothing
        return QFState(
            rem=plane(torch.int32, fr),
            occ=occ[:t],
            shf=plane(torch.bool, shf_bits),
            con=plane(torch.bool, con_bits),
            n=nn,
            overflow=overflow,
        )


def extract(cfg: QFConfig, state: QFState):
    """Decode the filter back to sorted fingerprints.

    Returns (fq, fr, n): int64 (total_slots,) arrays whose first n
    entries are the sorted fingerprint multiset (padding = sentinels).
    """
    with tracing.span("qf.extract"):
        fq, fr = decode_planes(state.rem, state.occ, state.shf, state.con)
    return fq, fr, state.n


def decode_planes(rem, occ, shf, con):
    """The sorted fingerprints held by the planes, sentinel-padded to their length."""
    t = rem.shape[0]
    dev = rem.device
    nonempty = occ | shf  # continuation implies shifted
    run_start = nonempty & ~con
    run_id = torch.cumsum(run_start, 0, dtype=torch.int32)
    occ_cum = torch.cumsum(occ, 0, dtype=torch.int32)
    # bucket of the j-th run = index of the j-th set is_occupied bit
    bucket_of_run = torch.searchsorted(occ_cum, run_id)
    fq_slot = torch.where(nonempty, bucket_of_run, INT32_MAX)
    fr_slot = torch.where(nonempty, rem.to(torch.int64) & M32, UINT32_MAX)
    dest = torch.where(nonempty, torch.cumsum(nonempty, 0) - 1, t)
    fq_out = torch.full((t + 1,), INT32_MAX, dtype=torch.int64, device=dev)
    fr_out = torch.full((t + 1,), UINT32_MAX, dtype=torch.int64, device=dev)
    fq_out[dest] = fq_slot
    fr_out[dest] = fr_slot
    return fq_out[:t], fr_out[:t]


def _extract_or_plain(fn):
    """``fn``, or the plain :func:`extract` where a caller passed none."""
    return extract if fn is None else fn


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------


def lex_searchsorted(qs, rs, fq, fr, side: str = "left"):
    """Rank of (fq, fr) in the lexicographically sorted (qs, rs)."""
    return torch.searchsorted(pack(qs, rs), pack(fq, fr), right=(side == "right"))


def lookup_exact(cfg: QFConfig, state: QFState, fq, fr) -> torch.Tensor:
    """Oracle lookup: decode + binary search. O(m) decode per batch."""
    return lookup_planes(state.rem, state.occ, state.shf, state.con, fq, fr)


def lookup_planes(rem, occ, shf, con, fq, fr) -> torch.Tensor:
    """:func:`lookup_exact` on bare planes; ``fq``/``fr`` of any integer type,
    ``fr`` read as unsigned 32-bit."""
    keys = pack(*decode_planes(rem, occ, shf, con))
    probe = pack(fq.to(torch.int64), fr.to(torch.int64) & M32)
    lo = torch.searchsorted(keys, probe).clamp(max=keys.shape[0] - 1)
    return keys[lo] == probe


def _window_decode(cfg: QFConfig, state: QFState, fq, fr, W: int):
    """One windowed-decode pass. Returns (present, overflow_flag)."""
    t = cfg.total_slots
    js = torch.arange(2 * W, device=fq.device)
    idx = (fq - W)[:, None] + js[None, :]
    valid = (idx >= 0) & (idx < t)
    idxc = idx.clamp(0, t - 1)

    occ = state.occ[idxc] & valid
    shf = state.shf[idxc] & valid
    con = state.con[idxc] & valid
    rem = torch.where(valid, state.rem[idxc], 0)
    nonempty = occ | shf

    occ_q = occ[:, W]  # is_occupied(A[f_q])

    # cluster/anchor start b: largest j <= W with !is_shifted
    upto_q = (js <= W)[None, :]
    b = torch.where(~shf & upto_q, js[None, :], -1).max(1).values
    ovf_left = b < 0

    # R = #occupied buckets in [b, fq]
    R = (occ & (js[None, :] >= b[:, None]) & upto_q).sum(1)

    cum = torch.cumsum(nonempty & ~con, 1)
    before = cum.gather(1, (b - 1).clamp(min=0)[:, None])[:, 0]
    C = torch.where(b > 0, before, 0) + R

    in_run = (cum == C[:, None]) & nonempty
    hit = in_run & (rem == fr.to(torch.int32)[:, None])
    present = occ_q & hit.any(1)

    ovf_right = in_run[:, -1]  # run may continue past the window
    ovf_nostart = occ_q & ~ovf_left & (cum[:, -1] < C)  # run start past window
    overflow = occ_q & (ovf_left | ovf_right | ovf_nostart)
    return present, overflow


# queries per windowed-decode chunk: bounds the (B x 2W) broadcast
_DECODE_ELEMS = 1 << 22


def lookup(cfg: QFConfig, state: QFState, fq, fr, window: int = 256):
    """MAY-CONTAIN for a batch of fingerprints (paper Fig. 3, vectorized).

    One ``2*window``-slot decode per query; queries whose cluster leaves
    the window retry at 4x the window, then fall back to the exact
    decode.  The queries run in chunks so the per-query windows stay a
    bounded allocation, and each fallback is a host branch: this is the
    plain path, not the kernel path of :mod:`repro_torch.kernels.ops`.
    """
    chunk = max(1, _DECODE_ELEMS // (2 * window))
    out = [torch.zeros(0, dtype=torch.bool, device=fq.device)]
    for s in range(0, fq.shape[0], chunk):
        cq, cr = fq[s : s + chunk], fr[s : s + chunk]
        present, ovf = _window_decode(cfg, state, cq, cr, window)
        if bool(ovf.any()):
            p2, o2 = _window_decode(cfg, state, cq, cr, min(4 * window, cfg.m))
            present = torch.where(ovf, p2, present)
            ovf = ovf & o2
            if bool(ovf.any()):
                exact = lookup_exact(cfg, state, cq, cr)
                present = torch.where(ovf, exact, present)
        out.append(present)
    return torch.cat(out)


def contains(cfg: QFConfig, state: QFState, keys: torch.Tensor, window: int = 256):
    """Key-level MAY-CONTAIN."""
    fq, fr = fingerprints(cfg, keys)
    return lookup(cfg, state, fq, fr, window)


# ---------------------------------------------------------------------------
# Bulk mutation: insert / delete / merge
# ---------------------------------------------------------------------------


def merge_sorted_with(
    cfg: QFConfig, state: QFState, fq, fr, k, build, extract=None
) -> QFState:
    """insert_sorted body with pluggable build and decode passes (plain or
    kernel; ``extract`` defaults to the plain one)."""
    qs, rs, n = _extract_or_plain(extract)(cfg, state)
    dev = qs.device
    kk = _i32(k, dev)
    with tracing.span("qf.sort"):
        valid = torch.cat(
            [
                torch.arange(qs.shape[0], device=dev) < n,
                torch.arange(fq.shape[0], device=dev) < kk,
            ]
        )
        allq, allr = _pad_sort(torch.cat([qs, fq]), torch.cat([rs, fr]), valid)
    new = build(cfg, allq, allr, n + kk)
    return new._replace(overflow=new.overflow | state.overflow)


def insert_sorted(cfg: QFConfig, state: QFState, fq, fr, k) -> QFState:
    """Insert a sorted batch of k fingerprints (merge + rebuild)."""
    return merge_sorted_with(cfg, state, fq, fr, k, build_sorted)


def _sorted_batch(cfg: QFConfig, keys, k):
    if k is None:
        k = keys.shape[0]
    fq, fr = fingerprints(cfg, keys)
    idx = torch.arange(keys.shape[0], device=fq.device)
    fq, fr = _pad_sort(fq, fr, idx < _i32(k, fq.device))
    return fq, fr, k


def insert(cfg: QFConfig, state: QFState, keys: torch.Tensor, k=None) -> QFState:
    """Insert a batch of keys (k = valid count; default all)."""
    fq, fr, k = _sorted_batch(cfg, keys, k)
    return insert_sorted(cfg, state, fq, fr, k)


def delete_sorted(
    cfg: QFConfig, state: QFState, fq, fr, k, build=None, extract=None
) -> QFState:
    """Delete (one copy of) each of k sorted fingerprints — multiset diff.

    ``build`` and ``extract`` swap the rebuild and decode passes as in
    :func:`multi_merge`.
    """
    if build is None:
        build = build_sorted
    qs, rs, n = _extract_or_plain(extract)(cfg, state)
    kk = _i32(k, qs.device)
    idx = torch.arange(qs.shape[0], device=qs.device)
    valid = idx < n
    # occurrence rank of element i among equal fingerprints
    rank = idx - lex_searchsorted(qs, rs, qs, rs, "left")
    # how many copies of this fingerprint are being deleted
    dlo = lex_searchsorted(fq, fr, qs, rs, "left")
    dhi = lex_searchsorted(fq, fr, qs, rs, "right")
    ndel = torch.minimum(dhi, kk) - torch.minimum(dlo, kk)
    keep = valid & (rank >= ndel)
    qs2, rs2 = _pad_sort(qs, rs, keep)
    return build(cfg, qs2, rs2, keep.sum(dtype=torch.int32))


def delete(cfg: QFConfig, state: QFState, keys: torch.Tensor, k=None) -> QFState:
    fq, fr, k = _sorted_batch(cfg, keys, k)
    return delete_sorted(cfg, state, fq, fr, k)


def merge(
    cfg_out: QFConfig,
    cfg_a: QFConfig,
    cfg_b: QFConfig,
    sa: QFState,
    sb: QFState,
    build=None,
    extract=None,
) -> QFState:
    """Merge two QFs into a (usually larger) output QF (paper Fig. 5).

    Requires identical fingerprint width q + r across all three configs.
    ``build`` and ``extract`` swap the rebuild and decode passes as in
    :func:`multi_merge`.
    """
    pa, pb, po = cfg_a.q + cfg_a.r, cfg_b.q + cfg_b.r, cfg_out.q + cfg_out.r
    if not (pa == pb == po):
        raise ValueError("merge requires equal fingerprint width q + r")
    return multi_merge(cfg_out, [(cfg_a, sa), (cfg_b, sb)], build, extract)


def _requotient(fq, fr, cfg_in: QFConfig, cfg_out: QFConfig):
    """Move bits between quotient and remainder: (q, r) -> (q', r').

    Monotone w.r.t. lexicographic order, so sortedness is preserved.
    Padding rows keep the JAX package's values bit for bit.
    """
    dq = cfg_out.q - cfg_in.q
    if dq == 0:
        return fq, fr
    pad = fq == INT32_MAX
    if dq > 0:  # grow quotient: steal top dq bits of remainder
        top = fr >> (cfg_in.r - dq)
        fq2 = torch.where(pad, INT32_MAX, (fq << dq) | top)
        low = (fr & ((1 << (cfg_in.r - dq)) - 1)) << dq
        fr2 = torch.where(pad, UINT32_MAX, low)
        # keep remainder left-aligned in r_out bits: r_out = r_in - dq
        return fq2, fr2 >> (cfg_in.r - cfg_out.r)
    # shrink quotient: donate low |dq| quotient bits to the remainder top
    k = -dq
    lowbits = fq & ((1 << k) - 1)
    fq2 = torch.where(pad, INT32_MAX, fq >> k)
    fr2 = torch.where(pad, UINT32_MAX, (lowbits << cfg_in.r) | fr)
    return fq2, fr2


def multi_merge(cfg_out: QFConfig, parts, build=None, extract=None) -> QFState:
    """Merge any number of (cfg, state) QFs into one output QF.

    One decode pass per input + one sort + one build.  ``build`` swaps
    the rebuild pass (default :func:`build_sorted`; the kernel path
    passes ``kernels.ops.build_sorted``), ``extract`` the decode (default
    :func:`extract`; the kernel path passes ``kernels.ops.extract``).
    """
    if build is None:
        build = build_sorted
    extract = _extract_or_plain(extract)
    p_out = cfg_out.q + cfg_out.r
    qs_all, rs_all, valid_all = [], [], []
    n_total, overflow = None, None
    for cfg, state in parts:
        if cfg.q + cfg.r != p_out:
            raise ValueError("multi_merge requires equal fingerprint width")
        fq, fr, n = extract(cfg, state)
        fq, fr = _requotient(fq, fr, cfg, cfg_out)
        qs_all.append(fq)
        rs_all.append(fr)
        valid_all.append(torch.arange(fq.shape[0], device=fq.device) < n)
        n_total = n if n_total is None else n_total + n
        overflow = state.overflow if overflow is None else overflow | state.overflow
    allq, allr = _pad_sort(
        torch.cat(qs_all), torch.cat(rs_all), torch.cat(valid_all)
    )
    out = build(cfg_out, allq, allr, n_total)
    # an input whose slack had overflowed may already have lost entries;
    # the union must keep reporting that
    return out._replace(overflow=out.overflow | overflow)


def merge_ranks(aq, ar, na, bq, br, nb):
    """Where every row of two sorted fingerprint streams lands in their merge.

    Both inputs follow the extract/_pad_sort convention: sorted valid
    prefix (``na``/``nb`` entries) followed by sentinel padding.  Ties
    break a before b, and the padding of each side routes to its own
    tail, so ``(ra, rb)`` is a permutation of ``range(len(a) + len(b))``
    with the ``na + nb`` valid rows first, in order.
    """
    la, lb = aq.shape[0], bq.shape[0]
    ia = torch.arange(la, device=aq.device)
    ib = torch.arange(lb, device=aq.device)
    # ties break a-before-b: a ranks 'left' into b, b ranks 'right' into a
    ra = ia + lex_searchsorted(bq, br, aq, ar, "left")
    rb = ib + lex_searchsorted(aq, ar, bq, br, "right")
    # sentinel padding would collide: route it to the tail deterministically
    ra = torch.where(ia < na, ra, nb + ia)
    rb = torch.where(ib < nb, rb, la + ib)
    return ra, rb


def merge_streams(aq, ar, na, bq, br, nb, ranks=None):
    """Merge two lexicographically sorted fingerprint streams in O(n).

    The output has length ``len(a) + len(b)`` with the ``na + nb`` valid
    entries sorted first, placed by :func:`merge_ranks` (or by ``ranks``,
    its result when the caller needs it too), with no sort.
    """
    ra, rb = merge_ranks(aq, ar, na, bq, br, nb) if ranks is None else ranks
    n = ra.shape[0] + rb.shape[0]
    out_q = torch.empty(n, dtype=torch.int64, device=aq.device)
    out_r = torch.empty_like(out_q)
    out_q[ra], out_q[rb] = aq, bq
    out_r[ra], out_r[rb] = ar, br
    return out_q, out_r


def merge_streams_many(parts):
    """Fold any number of sorted ``(fq, fr, n)`` streams into one, sort-free.

    Returns ``(fq, fr, n)`` with length ``sum(len(part))``.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("merge_streams_many needs at least one stream")
    aq, ar, na = parts[0]
    na = _i32(na, aq.device)
    for bq, br, nb in parts[1:]:
        nb = _i32(nb, aq.device)
        aq, ar = merge_streams(aq, ar, na, bq, br, nb)
        na = na + nb
    return aq, ar, na


def resize(
    cfg: QFConfig, state: QFState, new_q: int, build=None, extract=None
) -> tuple[QFConfig, QFState]:
    """Dynamically resize (paper §3 'Resizing'): move bits between the
    remainder and the quotient, keeping every fingerprint.

    One decode, one requotient (monotone, so the stream stays sorted),
    padding to the new slot count or a sort and cut when shrinking, then
    one build; ``build`` and ``extract`` swap the rebuild and decode
    passes as in :func:`multi_merge`.
    """
    if build is None:
        build = build_sorted
    new_cfg = cfg._replace(q=new_q, r=cfg.q + cfg.r - new_q)
    qs, rs, n = _extract_or_plain(extract)(cfg, state)
    qs, rs = _requotient(qs, rs, cfg, new_cfg)
    dev = qs.device
    pad = new_cfg.total_slots - qs.shape[0]
    if pad > 0:
        qs = torch.cat([qs, torch.full((pad,), INT32_MAX, dtype=qs.dtype, device=dev)])
        rs = torch.cat([rs, torch.full((pad,), UINT32_MAX, dtype=rs.dtype, device=dev)])
    elif pad < 0:
        # shrinking: all valid entries must fit; the sort pushes pads last
        qs, rs = _pad_sort(qs, rs, torch.arange(qs.shape[0], device=dev) < n)
        qs, rs = qs[: new_cfg.total_slots], rs[: new_cfg.total_slots]
    new = build(new_cfg, qs, rs, n)
    return new_cfg, new._replace(overflow=new.overflow | state.overflow)


# ---------------------------------------------------------------------------
# Item-at-a-time parity wrappers (paper semantics; used by tests)
# ---------------------------------------------------------------------------


def _one(key, state: QFState) -> torch.Tensor:
    return torch.as_tensor([key], dtype=torch.int64, device=state.rem.device)


def insert_one(cfg: QFConfig, state: QFState, key) -> QFState:
    return insert(cfg, state, _one(key, state))


def delete_one(cfg: QFConfig, state: QFState, key) -> QFState:
    return delete(cfg, state, _one(key, state))


def contains_one(cfg: QFConfig, state: QFState, key) -> torch.Tensor:
    return contains(cfg, state, _one(key, state))[0]
