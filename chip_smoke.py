#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each timed, any failure fatal (a traceback and exit code 1):

1. build    nvcc builds the seven CUDA kernels from ``src/repro_torch/csrc``;
            each is launched once on a small filter against its plain version,
            and the two quotient-filter kernels on small cases that reach
            every branch of their kernels (``build_cases``, ``probe_cases``);
            ``fingerprint`` on every (q, r) it takes, three seeds, int32 and
            int64 keys and both output types (``fingerprint_grid``);
            ``fuse_probe`` on small frozen filters of four cell widths at
            five seeds (``fuse_cases``).
2. kernels  each kernel against its plain PyTorch version on the card, bit
            for bit, at the main path's shapes (a q = 24 build of 12.6 M
            fingerprints, 2**22 probes and the fingerprints of their keys,
            the 7-structure cascade of phase 3 taken mid-stream, with its
            RAM structure Q0 partly full), timed with CUDA events beside the
            plain version, a library call where one computes the same
            function, and the kernel's bound.  The probes' plain version is
            the exact decode-and-search lookup, not a copy of the kernel's
            walk.
3. main     the paper's 1:4 SSD experiment (``benchmarks/bench_ssd.py``) with
            its 2**13 scale-down undone: 50,331,648 keys into
            ``buffered_qf(ram_q=24, disk_q=27, p=39)`` and
            ``cascade(ram_q=24, p=39, fanout=2, levels=6)`` under
            ``backend="pallas"``.  After 63 of the 64 batches (RAM tier
            partly full) and after the last, 2**21 probes of inserted keys
            (no false negative allowed) and 2**21 fresh keys (false-positive
            rate at most twice the union bound); every kernel must have
            launched (``fingerprint`` hashes every insert and probe).  Probe
            times are the median of several calls by CUDA events after the
            answered call.  The probes account their I/O on a copy of the
            state, so the ingest's own I/O schedule stays apart for phase 7.
4. backends the same stream under ``backend="reference"`` (the plain PyTorch
            path): planes, ``n``, ``overflow``, hits and I/O counters equal at
            both checkpoints.
5. bloom    the same 50,331,648 keys into bench_ssd's Bloom geometry with its
            scale-down undone (k = 12, m = n * 12 / ln 2 = 871,358,627 bits):
            ``bloom``, ``blocked_bloom`` (32 KiB blocks) and the counting
            ``blocked_bloom``, all under ``backend="pallas"``; 2**22 probes,
            half inserted keys (no false negative) and half fresh keys
            (false-positive rate at most twice (1 - e**(-k n / m))**k); the
            counting filter then deletes the first 8 batches and must still
            hold every key of the other 56.  Both Bloom kernels must have
            launched; each is then held against its plain version at these
            shapes.
6. bloom backends  the same ingest and deletes under ``backend="reference"``:
            cells, ``n`` and hits equal to phase 5's states.
7. baselines the paper's Bloom baselines of bench_ssd (EBF, BBF, FBF) at the
            same geometry, and the modeled SSD throughput of all five
            structures of its Table 1(b): insert, uniform lookup and
            successful lookup ops/s from each ``IOLog`` and the paper's SSD
            constants, with the cascade's and the buffered QF's insert
            speed-up over the best Bloom variant (the paper: 8.6-11x).
8. frozen   the same 50,331,648 keys into
            ``cascade(ram_q=24, p=39, fanout=2, levels=3, frozen_below=1)``
            under ``backend="pallas"``: bench_ssd's 1:4 experiment with the
            cold tier demoted as ``bench_xor_fuse.py`` does it.  Level 1
            is a binary-fuse table with 14-bit cells (levels=3: a frozen
            level 3 would need 2**15 segments); batch 48's merge-down
            peels 37,748,736 fingerprints into it.  At both checkpoints no
            false negative, and an fp rate at most twice the bound (the QF
            union bound plus 2**-fp_bits per non-empty frozen level: the
            first fp check of the QF side that can fail).  Each freeze's
            rounds, seed attempts and host reads are printed.  Then the
            ``xor_fuse`` family on its own: ``make(keys=...)`` at full load
            on the first ``XF_KEYS`` keys, ``grow``, and ``merge`` with a
            filter of the next ``XF_KEYS``; no overflow, no false negative,
            fp rate at most twice 2**-14.  ``fuse_probe`` and ``fingerprint``
            must have launched; ``fuse_probe`` is then held against its plain
            version (``fuse_hash`` and three gathers) on 2**22 queries, and
            the kernel path's ``ops.contains``, ``ops.cascade_lookup`` and
            ``ops.fuse_lookup`` run once more under
            ``torch.cuda.set_sync_debug_mode("error")``: no host sync.
9. frozen backends  the frozen cascade's stream under ``backend="reference"``:
            every level (fuse tables, runs, ``n``, ``n_unique``,
            ``fuse_seed``, ``overflow``; QF planes), the I/O counters and the
            hits equal to phase 8's at both checkpoints.  Phases 4 and 9 so
            hold the fingerprint kernel, which hashes the pallas side's keys,
            to the plain chain of the reference side on every key.
10. report  one JSON line of per-kernel results, then the card's name and
            power limit, then the result line.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", ...}}``; nothing is printed
in its place when the card or the package is missing.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    from repro_torch import filters
    from repro_torch.core import bf_variants, bloom, cost_model
    from repro_torch.core import fuse_filter as fuse
    from repro_torch.core import quotient_filter as qf
    from repro_torch.filters import bloom_filter
    from repro_torch.kernels import bloom_block, cascade_probe, cuda_lib, qf_build
    from repro_torch.kernels import fingerprint, fuse_probe, ops, qf_probe
except ModuleNotFoundError as e:  # run outside the repository
    if not (e.name or "").startswith("repro_torch"):
        raise
    filters = None

H100_BYTES_PER_S = 3.35e12  # HBM3 rate of the H100 SXM data sheet

# main path: bench_ssd.py's 1:4 experiment at the paper's scale
RAM_Q = 24
P_BITS = 39
RATIO = 4
BATCHES = 64
MID_BATCHES = BATCHES - 1  # the mid-stream checkpoint: RAM tiers partly full
PROBES = 1 << 21
PARITY_PROBES = 1 << 22
PROBE_REPS = 5  # timed probe calls per probe set; their median is reported
SEED = RATIO  # bench_ssd seeds its generator with the ratio

# bench_ssd's Bloom geometry: k = 12, m = n * k / ln 2, 32 KiB BBF blocks
BLOOM_K = 12
BLOCK_BITS = 4096 * 8 * 8
DELETED_BATCHES = 8  # the counting filter deletes the first 8 batches
PAPER_LOOKUPS = 2048  # bench_ssd's lookup sets

# the frozen tier: at ram_q = 24 a frozen level 3 would need 2**15 fuse
# segments or more, which the 32-bit start mix refuses, so levels = 3
FROZEN_LEVELS = 3
FROZEN_BELOW = 1  # bench_xor_fuse.py's value: level 1 frozen at load 0.75
XF_KEYS = 1 << 23  # the standalone xor_fuse filter, built at full load
XF_FP_BITS = 14  # level 1's cell width (cost_model.fuse_fp_bits_for(13))


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want, chunk: int = 1 << 26) -> int:
    """Largest absolute difference over paired outputs, as integers.

    Taken over flat chunks, so that a plane of a billion cells needs no
    int64 copy of its own size.
    """
    worst = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), chunk):
            d = a[i : i + chunk].to(torch.int64) - b[i : i + chunk].to(torch.int64)
            worst = max(worst, int(d.abs().max()))
    return worst


def uint32_keys(rng, n, device):
    """bench_ssd's ``keys_u32``: uniform uint32 keys from ``rng``, on ``device``."""
    keys = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(keys.view(np.int32)).to(device)


def sorted_stream(cfg, keys):
    fq, fr = qf.fingerprints(cfg, keys)
    return qf._pad_sort(fq, fr, torch.ones_like(fq, dtype=torch.bool))


def kernel_row(name, source, replaces, err, ms, plain_ms, bound_bytes, library_ms):
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}",
        "replaces": replaces,
        "max_abs_err": err,
        "bit_exact": err == 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_bytes / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def walk_spans(planes, fq, fr):
    """The slots each probe's cluster walk (``csrc/qf_walk.cuh``) reads.

    The paper's Fig. 3 walk, one step of every live query at a time:
    back to the cluster's start, count the occupied buckets up to the
    quotient, forward to that run, compare remainders.  Returns
    ``(present, first, last, run)``: the walk's answer, each query's span
    of slots (``first == last == fq`` where the bucket is empty; ``last``
    stops at the last slot, where a walk of an overflowed state would run
    off the planes), and the slot where its run starts, the first whose
    remainder it compares (``first`` where the bucket is empty, the
    number of slots where the walk ran off the planes before it).  It
    serves only the bound's byte and sector counts.
    """
    rem, occ, shf, con = planes
    t = rem.shape[0]
    dev = fq.device
    fq = fq.to(torch.int64)
    B = fq.shape[0]
    present = torch.zeros(B, dtype=torch.bool, device=dev)
    live = torch.arange(B, device=dev)[(fq >= 0) & (fq < t)]
    live = live[occ[fq[live]]]

    b = fq.clone()  # 1. back to the last unshifted slot
    a = live
    while a.numel():
        a = a[(b[a] > 0) & shf[b[a]]]
        b[a] -= 1
    R = torch.zeros(B, dtype=torch.int64, device=dev)  # 2. occupied in [b, fq]
    j = b.clone()
    a = live
    while a.numel():
        R[a] += occ[j[a]]
        a = a[j[a] < fq[a]]
        j[a] += 1
    s = b.clone()  # 3. forward to the start of the R-th run
    c = torch.ones(B, dtype=torch.int64, device=dev)
    off = torch.zeros(B, dtype=torch.bool, device=dev)
    a = live[R[live] > 1]
    while a.numel():
        s[a] += 1
        end = s[a] >= t
        off[a[end]] = True
        a = a[~end]
        sa = s[a]
        c[a] += ((occ[sa] | shf[sa]) & ~con[sa]).to(torch.int64)
        a = a[c[a] < R[a]]
    run = s.clone()
    fr32 = fr.to(torch.int32)  # 4. compare remainders along the run
    a = live[~off[live]]
    while a.numel():
        hit = rem[s[a]] == fr32[a]
        present[a[hit]] = True
        a = a[~hit]
        s[a] += 1
        a = a[s[a] < t]
        a = a[con[s[a]]]
    return present, b, s.clamp(max=t - 1), run


def walked_bytes(planes, fq, fr) -> int:
    """Bytes the cluster walks of these queries must read, each slot once.

    The three metadata planes over the union of the walked spans, plus
    the ``occ`` byte of each distinct empty bucket probed.  The ``rem``
    bytes of the runs compared are left out, so this is a lower bound.
    """
    occ = planes[1]
    t = occ.shape[0]
    _, first, last, _ = walk_spans(planes, fq, fr)
    fq = fq.to(torch.int64)
    walked = occ[fq]
    one = torch.ones(int(walked.sum()), dtype=torch.int32, device=fq.device)
    diff = torch.zeros(t + 1, dtype=torch.int32, device=fq.device)
    diff.index_add_(0, first[walked], one)
    diff.index_add_(0, last[walked] + 1, -one)
    covered = int((torch.cumsum(diff, 0)[:t] > 0).sum())
    empty_buckets = int(torch.unique(fq[~walked]).numel())
    return 3 * covered + empty_buckets


def i32(x):
    """int64 fingerprints as the kernels take them: the low 32 bits, int32."""
    return x.to(torch.int32)


def canonical_queries(cfg, keys):
    """Keys hashed once in the cascade's canonical split, as int32 (fq, fr, r)."""
    qc, rc = fuse.canonical_split(cfg.p)
    canon = qf.QFConfig(q=qc, r=rc, slack=0, seed=cfg.seed)
    fq, fr = qf.fingerprints(canon, keys)
    return i32(fq), i32(fr), rc


# ---------------------------------------------------------------------------
# phases 1 and 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def bloom_probe_cases(rng, cells, device):
    """Small ``bloom_probe`` inputs that reach every branch of its kernel.

    At k = 3, 4, 12 and 13 (ragged and whole groups), 300 rows (not a
    multiple of the 256-thread block), half of them drawn from set cells
    (every group read) and half uniform (an early stop); and the k = 12
    rows once more as a contiguous view that starts 4 bytes past an
    allocation (so off every 8- and 16-byte boundary).
    """
    ncells = cells.shape[0]
    set_cells = torch.nonzero(cells).flatten().cpu().numpy()
    out = []
    for k in (3, 4, 12, 13):
        rows = np.concatenate([
            rng.choice(set_cells, (150, k)), rng.integers(0, ncells, (150, k))
        ])
        idx = torch.from_numpy(rows.astype(np.int32)).to(device)
        out.append(idx)
        if k == 12:
            out.append(torch.cat([idx.new_zeros(1), idx.flatten()])[1:].view(idx.shape))
    return out


def cascade_case(planes, nn, cfg, device):
    """32 levels over one small table: live (its count), stale (its planes,
    count 0) and empty (zero planes, count 0) in turn, the last one live."""
    empty = tuple(torch.zeros_like(p) for p in planes)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    kinds = [("live", "stale", "empty")[lvl % 3] for lvl in range(31)] + ["live"]
    level_planes = [empty if k == "empty" else planes for k in kinds]
    level_n = [nn if k == "live" else zero for k in kinds]
    return level_planes, level_n, [cfg.r] * 32


def build_cases(device):
    """Small ``qf_build_planes`` inputs that reach every branch of its kernel.

    Returns ``(label, args)`` pairs.  A q = 13 table at load 0.95 with a
    run of 40 items at bucket 4070, so that a cluster and a run cross the
    first 4096-slot tile's end, on 9216 slots (not a multiple of 4096);
    the same items with fewer valid and with none valid; and items
    packed at the end of a table with 16 slots of slack, the last ones
    dropped past the last slot.
    """
    rng = np.random.default_rng(5)
    out = []

    def stream(cfg, fq):
        fq = np.sort(fq)
        fr = rng.integers(0, 1 << cfg.r, fq.shape[0])
        o = np.lexsort((fr, fq))
        fq = torch.from_numpy(fq[o]).to(device)
        fr = torch.from_numpy(fr[o]).to(device)
        nn, _, pos, _ = qf.probe_positions(cfg, fq, fq.shape[0])
        return i32(pos), i32(fq), i32(fr), nn

    cfg = qf.QFConfig(q=13, r=10)
    fq = np.concatenate([rng.integers(0, cfg.m, int(0.95 * cfg.m) - 40), [4070] * 40])
    pos, fq, fr, nn = stream(cfg, fq)
    t = cfg.total_slots
    out.append(("load 0.95, across a tile's end", (pos, fq, fr, nn, t)))
    out.append(("fewer valid than items", (pos, fq, fr, nn - 1000, t)))
    out.append(("none valid", (pos, fq, fr, nn * 0, t)))
    cfg = qf.QFConfig(q=13, r=10, slack=16)
    pos, fq, fr, nn = stream(cfg, rng.integers(cfg.m - 700, cfg.m, 760))
    out.append(("items dropped past the last slot", (pos, fq, fr, nn, cfg.total_slots)))
    return out


def probe_cases(device, build_args):
    """Small ``qf_probe`` inputs that reach every branch of its kernels.

    Returns ``(label, planes, fq, fr)``.  On the load-0.95 table of
    ``build_cases`` (9216 slots, clusters across 32-slot words): its
    items (in their sorted order) and uniform keys, shuffled; 1000 of
    them twice over (duplicates; 2000 queries, not a multiple of the
    256-thread block); quotients below 0 and at or past the last slot;
    no query.  On a q = 12 table with a run of 600 slots, walks of many
    words, forward from bucket 1000 and back from 1500.  The first table
    again, each plane a view one element past a 16-byte boundary (the
    pack's unaligned loads).  On a q = 14 table, 300 uniform queries:
    sparse, so the wrapper walks the byte planes.  And a state whose
    ``overflow`` flag is set on 34 slots (a ragged last word), where
    walks run off the end of the planes.
    """
    rng = np.random.default_rng(6)
    pos, fq, fr, nn, t = build_args
    planes = qf_build.qf_build_planes(pos, fq, fr, nn, t)
    n = int(nn)
    fq_u = torch.from_numpy(rng.integers(0, t, n)).to(device)
    fr_u = torch.from_numpy(rng.integers(0, 1 << 10, n)).to(device)
    perm = torch.from_numpy(rng.permutation(2 * n)).to(device)
    mq, mr = torch.cat([fq[:n], i32(fq_u)])[perm], torch.cat([fr[:n], i32(fr_u)])[perm]
    edge = torch.tensor(
        [-1, -(2**31), t, t + 100, 2**31 - 1, 0, t - 1], dtype=torch.int32, device=device
    )
    out = [
        ("unsorted members and uniform", planes, mq, mr),
        ("duplicates", planes, mq[:1000].repeat(2), mr[:1000].repeat(2)),
        ("quotients off the planes", planes, edge, edge),
        ("no query", planes, mq[:0], mr[:0]),
    ]
    # a run of 600 at bucket 1000 on a q = 12 table: walks across many
    # 32-slot words, forward from bucket 1000 and back from 1500
    cfg = qf.QFConfig(q=12, r=10)
    lq = np.sort(np.concatenate([rng.integers(0, cfg.m, 1500), [1000] * 600]))
    lr = rng.integers(0, 1 << 10, lq.shape[0])
    lr[lq == 1000] = np.arange(600)
    o = np.lexsort((lr, lq))
    lq, lr = (torch.from_numpy(a[o]).to(device) for a in (lq, lr))
    nn, _, lpos, _ = qf.probe_positions(cfg, lq, lq.shape[0])
    long_run = qf_build.qf_build_planes(i32(lpos), i32(lq), i32(lr), nn, cfg.total_slots)
    fwd = torch.full((300,), 1000, dtype=torch.int32, device=device)
    back = torch.full((300,), 1500, dtype=torch.int32, device=device)
    tail = torch.arange(300, 600, dtype=torch.int32, device=device)
    out.append(("a run of 600, forward", long_run, fwd, tail))
    out.append(("a run of 600, back", long_run, back, tail))
    shifted = tuple(torch.cat([x[:1], x])[1:] for x in planes)
    out.append(("planes off a 16-byte boundary", shifted, mq, mr))
    cfg = qf.QFConfig(q=14, r=10)
    keys = uint32_keys(rng, int(0.75 * cfg.m), device)
    state = qf.insert(cfg, qf.empty(cfg, device), keys)
    wide = (state.rem, state.occ, state.shf, state.con)
    q14, r14 = qf.fingerprints(cfg, torch.cat([keys[:150], uint32_keys(rng, 150, device)]))
    out.append(("sparse queries", wide, i32(q14), i32(r14)))
    cfg = qf.QFConfig(q=5, r=8, slack=2)
    keys = uint32_keys(rng, 60, device)
    state = qf.insert(cfg, qf.empty(cfg, device), keys)
    if not bool(state.overflow):
        raise AssertionError("the overflow case's state did not overflow")
    q5, r5 = qf.fingerprints(cfg, torch.cat([keys, uint32_keys(rng, 60, device)]))
    out.append(("overflowed state", (state.rem, state.occ, state.shf, state.con),
                i32(q5), i32(r5)))
    return out


def fingerprint_grid(device) -> None:
    """``fingerprint`` against its plain version on 1,004 int32 keys (half
    with the high bit set, and the edges) and 1,003 int64 keys (their high
    words set), for every (q, r) with 1 <= q <= 30 and 1 <= r <= 32, seeds
    0, 5 and 2**31 - 1, into int32 and into int64: 23,040 launches."""
    rng = np.random.default_rng(3)
    k32 = np.concatenate([rng.integers(-(2**31), 2**31, 1000),
                          [0, -1, 2**31 - 1, -(2**31)]])
    k64 = np.concatenate([rng.integers(-(2**62), 2**62, 1000),
                          [2**32, -1, 2**40 + 5]])
    keysets = [torch.from_numpy(k32.astype(np.int32)).to(device),
               torch.from_numpy(k64.astype(np.int64)).to(device)]
    cases, bad = [], []
    for seed in (0, 5, 2**31 - 1):
        for q in range(1, 31):
            for r in range(1, 33):
                for keys in keysets:
                    want = fingerprint.fingerprint_plain(keys, q, r, seed, torch.int64)
                    for dtype in (torch.int32, torch.int64):
                        got = fingerprint.fingerprint(keys, q, r, seed, dtype)
                        same = [torch.equal(g, w.to(dtype)) for g, w in zip(got, want)]
                        cases.append((seed, q, r, keys.dtype, dtype))
                        bad.append(not all(same))
    if any(bad):
        raise AssertionError(
            f"fingerprint disagrees with its plain version at (seed, q, r, key "
            f"dtype, out dtype) {cases[bad.index(True)]}"
        )


def fuse_cases(device) -> list:
    """Small ``fuse_probe`` inputs: a frozen filter of 180 keys at p = 39
    (its peel runs on the card too) for each cell width 1, 8, 14 and 28,
    probed with its keys and 180 others at its own seed (a tensor; its keys
    must all hit) and at seeds 0, 5 and 2**31 - 1 (host ints) and 12345 (a
    tensor).  Returns ``(label, got, want)`` checks."""
    keys = uint32_keys(np.random.default_rng(1), 360, device)
    out = []
    for fp_bits in (1, 8, 14, 28):
        fcfg = fuse.make_config(180, p=P_BITS, fp_bits=fp_bits)
        fstate = fuse.freeze_keys(fcfg, keys[:180])
        fq, fr = map(i32, fuse.key_fingerprints(fcfg, keys))
        geometry = (fcfg.segment_length, fcfg.segment_count, fp_bits)
        other = torch.full((), 12345, dtype=torch.int32, device=device)
        for seed in (fstate.fuse_seed, 0, 5, 2**31 - 1, other):
            args = (fstate.table, fq, fr, seed, *geometry)
            got = fuse_probe.fuse_probe(*args)
            label = f"fuse_probe (fp_bits {fp_bits}, seed {int(seed)})"
            out.append((label, (got,), (fuse_probe.fuse_probe_plain(*args),)))
            if seed is fstate.fuse_seed and not bool(got[:180].all()):
                raise AssertionError(f"{label}: a key of the small frozen filter "
                                     "was lost")
    return out


def launch_check(device) -> None:
    """Launch each kernel once on a small filter and hold it to its plain version.

    This also loads every library and module before anything is timed.
    """
    cfg = qf.QFConfig(q=8, r=12)
    fq, fr = sorted_stream(cfg, uint32_keys(np.random.default_rng(0), 180, device))
    nn, _, pos, _ = qf.probe_positions(cfg, fq, 180)
    fq, fr = i32(fq), i32(fr)
    args = (i32(pos), fq, fr, nn, cfg.total_slots)
    planes = qf_build.qf_build_planes(*args)
    qargs = (*planes, fq, fr)
    # the same table twice, one level read in the split (q, r) = (4, 16);
    # then 32 levels, empty and stale ones among the live
    split = (fq >> 4, (fq & 15) << 12 | fr, 16)
    cases = [
        ([planes, planes], [nn, nn], [cfg.r, cfg.r]),
        cascade_case(planes, nn, cfg, device),
    ]
    bidx = torch.cat([i32(fq) & 255, torch.full((9,), 2**31 - 1, device=device)])
    bidx = bidx.to(torch.int32)
    bcells = bloom_block.bloom_count(bidx, 256)
    pcases = bloom_probe_cases(np.random.default_rng(2), bcells > 1, device)
    checks = [
        (f"bloom_probe ({c.dtype}, k = {p.shape[1]})",
         (bloom_block.bloom_probe(c, p),), (bloom_block.bloom_probe_plain(c, p),))
        for c in ((bcells > 1).to(torch.uint8), (bcells - 1).to(torch.int16))
        for p in pcases
    ]
    chits = [cascade_probe.cascade_probe(*c, *split) for c in cases]
    checks += [
        (f"cascade_probe (L = {len(c[0])})", (h,),
         (cascade_probe.cascade_probe_plain(*c, *split),))
        for c, h in zip(cases, chits)
    ]
    checks += [
        ("bloom_count", (bcells,), (bloom_block.bloom_count_plain(bidx, 256),)),
        ("qf_build_planes", planes, qf_build.build_planes_plain(*args)),
        ("qf_probe", (qf_probe.qf_probe(*qargs),), (qf_probe.probe_plain(*qargs),)),
    ]
    bcases = build_cases(device)
    checks += [
        (f"qf_build_planes ({label})", qf_build.qf_build_planes(*a),
         qf_build.build_planes_plain(*a))
        for label, a in bcases
    ]
    for label, p, q, r in probe_cases(device, bcases[0][1]):
        want = (qf_probe.probe_plain(*p, q, r),)
        checks.append((f"qf_probe ({label})", (qf_probe.qf_probe(*p, q, r),), want))
        # each walk, whichever the wrapper picks for this case
        bits = qf_probe.pack_bits(*p[1:])
        checks.append((f"qf_probe's bit walk ({label})",
                       (qf_probe.walk(*p, q, r, bits),), want))
        checks.append((f"qf_probe's byte walk ({label})", (qf_probe.walk(*p, q, r),), want))
    checks += fuse_cases(device)
    torch.cuda.synchronize()
    for name, got, want in checks:
        if max_abs_err(got, want) != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    fingerprint_grid(device)
    # of the 32 levels, 0, 3, ..., 30 and 31 are live: every key hits them all
    live = sum(1 << lvl for lvl in range(0, 31, 3)) | 1 << 31
    if not bool((chits[1][:180] == live - 2**32).all()):
        raise AssertionError("cascade_probe: a live level missed, or a dead one hit")


def check_build(device):
    """qf_build_planes at a q = 24 build of 0.75 * 2**24 fingerprints."""
    cfg = qf.QFConfig(q=RAM_Q, r=P_BITS - RAM_Q)
    keys = uint32_keys(np.random.default_rng(SEED), cfg.capacity, device)
    fq, fr = sorted_stream(cfg, keys)
    nn, valid, pos, _ = qf.probe_positions(cfg, fq, cfg.capacity)
    t = cfg.total_slots
    pos, fq, fr = i32(pos), i32(fq), i32(fr)
    args = (pos, fq, fr, nn, t)
    got = qf_build.qf_build_planes(*args)
    err = max_abs_err(got, qf_build.build_planes_plain(*args))
    ms = cuda_ms(lambda: qf_build.qf_build_planes(*args), 10)
    plain_ms = cuda_ms(lambda: qf_build.build_planes_plain(*args), 5)

    # the library's scatter of the same planes: index_put_ into zeroed planes
    slot = torch.where(valid & (pos < t), pos, t)
    bucket = torch.where(valid, fq, t)
    first = torch.arange(fq.shape[0], device=device) > 0
    values = (fr, pos != fq, first & (torch.roll(fq, 1) == fq))
    true = torch.ones((), dtype=torch.bool, device=device)

    def library():
        rem = torch.zeros(t + 1, dtype=torch.int32, device=device)
        occ, shf, con = (
            torch.zeros(t + 1, dtype=torch.bool, device=device) for _ in range(3)
        )
        rem.index_put_((slot,), values[0])
        occ.index_put_((bucket,), true)
        shf.index_put_((slot,), values[1])
        con.index_put_((slot,), values[2])

    library_ms = cuda_ms(library, 10)
    bound_bytes = 3 * 4 * fq.shape[0] + 4 + 7 * t  # pos/fq/fr, n read; planes written
    row = kernel_row(
        "qf_build_planes", "qf_build.cu", "src/repro/kernels/qf_build.py:88",
        err, ms, plain_ms, bound_bytes, library_ms,
    )
    return row, (cfg, got, keys)


def check_probe(device, built):
    """qf_probe: 2**22 probes, half inserted keys and half uniform, on q = 24."""
    cfg, planes, keys = built
    rng = np.random.default_rng(SEED + 1)
    half = PARITY_PROBES // 2
    hits = keys[torch.from_numpy(rng.integers(0, keys.shape[0], half)).to(device)]
    probes = torch.cat([hits, uint32_keys(rng, half, device)])
    fq, fr = qf.fingerprints(cfg, probes)
    fq, fr = i32(fq), i32(fr)
    got = qf_probe.qf_probe(*planes, fq, fr)
    err = max_abs_err([got], [qf_probe.probe_plain(*planes, fq, fr)])
    if not bool(got[:half].all()):
        raise AssertionError("qf_probe: an inserted key was not found")
    ms = cuda_ms(lambda: qf_probe.qf_probe(*planes, fq, fr), 20)
    plain_ms = cuda_ms(lambda: qf_probe.probe_plain(*planes, fq, fr), 2)
    pack_ms = cuda_ms(lambda: qf_probe.pack_bits(*planes[1:]), 20)
    bits = qf_probe.pack_bits(*planes[1:])
    walk_ms = cuda_ms(lambda: qf_probe.walk(*planes, fq, fr, bits), 20)
    # fq/fr read (4 + 4 bytes), present written (1), and the walked slots
    bound_bytes = walked_bytes(planes, fq, fr) + PARITY_PROBES * (4 + 4 + 1)
    meta, rem = walk_sectors(planes, fq, fr)
    empty = int((~planes[1][fq.to(torch.int64)]).sum())
    log(
        f"  qf_probe: {ms:.5f} ms a call of {PARITY_PROBES} queries: pack "
        f"{pack_ms:.5f} ms ({bits.numel() * 4} bytes of bit planes), walk "
        f"{walk_ms:.5f} ms"
    )
    log(
        f"  qf_probe gathers: on the byte planes about {meta + rem + empty} "
        f"sectors (walk_sectors: {meta} metadata, {rem} rem of the runs, and "
        f"{empty} occ of empty buckets); on the bit planes, which stay in L2, "
        f"the {rem} rem sectors come from the card's memory: "
        f"{rem / walk_ms / 1e6:.4f} G sectors/s over the walk"
    )
    row = kernel_row(
        "qf_probe", "qf_probe.cu", "src/repro/kernels/qf_probe.py:158",
        err, ms, plain_ms, bound_bytes, None,
    )
    return row, probes


def check_fingerprint(cfg, keys):
    """fingerprint of ``check_probe``'s 2**22 keys at p = 39 in the q = 24
    split (24, 15), into int32 (the probes' pairs; the row) and into int64
    (the inserts' pairs; logged)."""
    args = (keys, cfg.q, cfg.r, cfg.seed)
    err, times = 0, {}
    for dtype in (torch.int64, torch.int32):
        got = fingerprint.fingerprint(*args, dtype)
        err = max(err, max_abs_err(got, fingerprint.fingerprint_plain(*args, dtype)))
        ms = cuda_ms(lambda: fingerprint.fingerprint(*args, dtype), 20)
        plain_ms = cuda_ms(lambda: fingerprint.fingerprint_plain(*args, dtype), 5)
        times[dtype] = (ms, plain_ms)
        bound = keys.shape[0] * (4 + 2 * got[0].element_size())
        log(f"  fingerprint of {keys.shape[0]} int32 keys into {dtype}: {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound / H100_BYTES_PER_S * 1e3:.6f} ms")
    ms, plain_ms = times[torch.int32]
    # a 4-byte key read, two 4-byte words written
    return kernel_row(
        "fingerprint", "fingerprint.cu", "src/repro/core/fingerprint.py:76",
        err, ms, plain_ms, keys.shape[0] * 12, None,
    )


def walk_sectors(planes, fq, fr) -> tuple:
    """32-byte sectors the cluster walks of these queries touch, counted per
    query whose bucket is occupied: the sectors of its walked span in each
    of the three metadata planes (an upper estimate: not every plane is
    read over the whole span), and those of its run in ``rem``, which is
    read there only.  Returns ``(metadata sectors, rem sectors)``."""
    occ = planes[1]
    t = occ.shape[0]
    walked = occ[fq.to(torch.int64)]
    _, first, last, run = walk_spans(planes, fq, fr)
    first, last, run = first[walked], last[walked], run[walked]
    meta = (last >> 5) - (first >> 5) + 1  # one-byte planes occ, shf, con
    rem = torch.where(run < t, (last >> 3) - (run.clamp(max=t - 1) >> 3) + 1, 0)
    return int(3 * meta.sum()), int(rem.sum())


def check_cascade(device, cfg, state, inserted):
    """cascade_probe over the main path's 7-structure cascade, 2**22 probes."""
    cfgs = [cfg.q0_cfg] + [cfg.level_cfg(i) for i in range(cfg.levels)]
    structs = (state.q0, *state.levels)
    planes = [(s.rem, s.occ, s.shf, s.con) for s in structs]
    counts = [s.n for s in structs]
    widths = [c.r for c in cfgs]
    rng = np.random.default_rng(SEED + 2)
    half = PARITY_PROBES // 2
    pick = torch.from_numpy(rng.integers(0, inserted.shape[0], half)).to(device)
    probes = torch.cat([inserted[pick], uint32_keys(rng, half, device)])
    fq, fr, rc = canonical_queries(cfg, probes)
    args = (planes, counts, widths, fq, fr, rc)
    got = cascade_probe.cascade_probe(*args)
    err = max_abs_err([got], [cascade_probe.cascade_probe_plain(*args)])
    if not bool((got[:half] != 0).all()):
        raise AssertionError("cascade_probe: an inserted key was not found")
    ms = cuda_ms(lambda: cascade_probe.cascade_probe(*args), 10)
    plain_ms = cuda_ms(lambda: cascade_probe.cascade_probe_plain(*args), 1)
    # fq/fr read once (4 + 4 bytes), hit written (4), each level's 4-byte
    # count, and per live structure the slots its walks cover, each at its
    # own split of the fingerprint; a level whose count is 0 is not read
    f = (fq.to(torch.int64) << rc) | (fr.to(torch.int64) & 0xFFFFFFFF)
    occupied = [int(n) for n in counts]
    walk_bytes, every_level_bytes, occ_reads, sectors = 0, 0, 0, 0
    for p, r, n in zip(planes, widths, occupied):
        lq, lr = f >> r, f & ((1 << r) - 1)
        b = walked_bytes(p, lq, lr)
        every_level_bytes += b
        if n > 0:
            walk_bytes += b
            occ_reads += PARITY_PROBES
            sectors += sum(walk_sectors(p, lq, lr))
    bound_bytes = walk_bytes + 4 * len(planes) + PARITY_PROBES * (4 + 4 + 4)
    old_bound = every_level_bytes + PARITY_PROBES * (4 + 4 + 4)
    log(f"  cascade_probe checked on a cascade holding {occupied} fingerprints")
    log(
        f"  cascade_probe bound {bound_bytes / H100_BYTES_PER_S * 1e3:.6f} ms "
        f"over the {sum(n > 0 for n in occupied)} live levels (reading every "
        f"level: {old_bound / H100_BYTES_PER_S * 1e3:.6f} ms)"
    )
    dead_reads = PARITY_PROBES * len(planes) - occ_reads
    log(
        f"  cascade_probe gathers: {occ_reads} occ sectors of live levels, about "
        f"{sectors} walk sectors, {dead_reads} occ sectors of empty levels not "
        f"read; {(occ_reads + sectors) / ms / 1e6:.4f} G sectors/s, "
        f"{(occ_reads + sectors) * 32 / ms / 1e9:.4f} TB/s of sectors"
    )
    return kernel_row(
        "cascade_probe", "cascade_probe.cu", "src/repro/kernels/cascade_probe.py:150",
        err, ms, plain_ms, bound_bytes, None,
    )


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path, under each backend
# ---------------------------------------------------------------------------


def specs(backend: str) -> dict:
    disk_q = RAM_Q + 3  # bench_ssd: RAM_Q + max(2, ceil(log2(ratio * 1.8)))
    return {
        "buffered_qf": dict(ram_q=RAM_Q, disk_q=disk_q, p=P_BITS, backend=backend),
        "cascade": dict(ram_q=RAM_Q, p=P_BITS, fanout=2, levels=6, backend=backend),
    }


def timed_probe(cfg, state, probes):
    """``filters.probe`` once for its answer and state, then ``PROBE_REPS``
    more calls on the same input, each timed by CUDA events; median ms."""
    new_state, hit = filters.probe(cfg, state, probes)
    times = []
    for _ in range(PROBE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        filters.probe(cfg, state, probes)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return new_state, hit, statistics.median(times)


def drive(name, spec, keys, checkpoints, on_batch=None):
    """Ingest ``keys`` in ``BATCHES`` batches through the façade, probing on the way.

    ``checkpoints`` maps a number of batches ingested to the key sets
    probed right after them.  The probes' I/O is accounted on the probed
    state, not on the one the ingest goes on with.  ``on_batch(b,
    seconds)`` is called after each insert.  Returns the config, the
    ingest wall time, per checkpoint ``(probed state, hits, probe ms)``,
    and the state after the last batch.
    """
    cfg, state = filters.make(name, **spec)
    step = keys.shape[0] // BATCHES
    ingest_s, out = 0.0, {}
    for b in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = filters.insert(cfg, state, keys[b * step : (b + 1) * step])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ingest_s += seconds
        if on_batch is not None:
            on_batch(b, seconds)
        if b + 1 in checkpoints:
            probed, hits, probe_ms = state, [], []
            for probes in checkpoints[b + 1]:
                probed, hit, ms = timed_probe(cfg, probed, probes)
                hits.append(hit)
                probe_ms.append(ms)
            out[b + 1] = (probed, hits, probe_ms)
    return cfg, ingest_s, out, state


def union_bound(cfg, state) -> float:
    """The fp-rate bound: a sum over the non-empty structures of
    n / 2**q * 2**-r for a QF and 2**-fp_bits for a frozen level."""
    if hasattr(cfg, "q0_cfg"):
        parts = [(cfg.q0_cfg, state.q0)] + [
            (cfg.fuse_cfg(i) if cfg.is_frozen(i) else cfg.level_cfg(i), s)
            for i, s in enumerate(state.levels)
        ]
    else:
        parts = [(cfg.ram, state.ram), (cfg.disk, state.disk)]

    def rate(c, s):
        if isinstance(c, fuse.FuseConfig):
            return 2.0**-c.fp_bits
        return int(s.n) / 2**c.q * 2.0**-c.r

    return sum(rate(c, s) for c, s in parts if int(s.n) > 0)


def fresh_keys(rng, inserted_sorted, n, device):
    """``n`` uniform uint32 keys none of which was inserted."""
    out = []
    while sum(k.shape[0] for k in out) < n:
        cand = uint32_keys(rng, n, device).to(torch.int64) & 0xFFFFFFFF
        pos = torch.searchsorted(inserted_sorted, cand).clamp(
            max=inserted_sorted.shape[0] - 1
        )
        out.append(cand[inserted_sorted[pos] != cand])
    return torch.cat(out)[:n]


# ---------------------------------------------------------------------------
# phases 5 to 7: the Bloom families and the paper's Bloom baselines
# ---------------------------------------------------------------------------


def bloom_m_bits(n_total: int) -> int:
    """bench_ssd's Bloom size: n * k / ln 2 bits."""
    return int(n_total * BLOOM_K / np.log(2))


def bloom_specs(n_total: int, backend: str) -> dict:
    """The three Bloom structures of phase 5, as (family, spec) by label."""
    base = dict(m_bits=bloom_m_bits(n_total), k=BLOOM_K, backend=backend)
    blocked = dict(base, block_bits=BLOCK_BITS)
    return {
        "bloom": ("bloom", base),
        "blocked_bloom": ("blocked_bloom", blocked),
        "counting blocked_bloom": ("blocked_bloom", dict(blocked, counting=True)),
    }


def bloom_fp_bound(n: int, cells: int) -> float:
    """The classic Bloom false-positive rate (1 - e**(-k n / m))**k."""
    return (1 - math.exp(-BLOOM_K * n / cells)) ** BLOOM_K


def drive_bloom(backend: str, keys, probes):
    """Ingest ``keys`` into the three Bloom structures, probe them once,
    then delete the first ``DELETED_BATCHES`` batches from the counting one.

    Returns per label ``(cfg, state, hits, probe ms, ingest s)`` and the
    counting structure's state after the deletes.
    """
    out = {}
    for label, (name, spec) in bloom_specs(keys.shape[0], backend).items():
        cfg, ingest_s, probed, state = drive(name, spec, keys, {BATCHES: (probes,)})
        _, (hit,), (ms,) = probed[BATCHES]
        out[label] = (cfg, state, hit, ms, ingest_s)
    cfg, state = out["counting blocked_bloom"][:2]
    step = keys.shape[0] // BATCHES
    for b in range(DELETED_BATCHES):
        state = filters.delete(cfg, state, keys[b * step : (b + 1) * step])
    return out, state


def check_deleted(cfg, state, keys) -> None:
    """Every key of the batches not deleted still hits, and ``n`` counts them."""
    step = keys.shape[0] // BATCHES
    for b in range(DELETED_BATCHES, BATCHES):
        batch = keys[b * step : (b + 1) * step]
        if not bool(filters.contains(cfg, state, batch).all()):
            raise AssertionError(f"counting blocked_bloom lost a key of batch {b}")
    want = (BATCHES - DELETED_BATCHES) * step
    if int(state.n) != want:
        raise AssertionError(f"counting blocked_bloom: n = {int(state.n)} != {want}")


def check_bloom_count(keys):
    """bloom_count on one batch's indices into the classic Bloom plane.

    The batch's last sixteenth is masked (``k=`` shorter than the
    batch), so its indices are INT32_MAX and must count nothing.
    """
    cfg = bloom_filter.BloomFilterConfig(m_bits=bloom_m_bits(keys.shape[0]), k=BLOOM_K)
    batch = keys[: keys.shape[0] // BATCHES]
    valid_keys = batch.shape[0] * 15 // 16
    idx = bloom_filter._masked(bloom_filter._indices(cfg, batch), batch, valid_keys)
    idx = idx.reshape(-1)
    ncells = cfg.m_bits
    got = bloom_block.bloom_count(idx, ncells)
    err = max_abs_err([got], [bloom_block.bloom_count_plain(idx, ncells)])
    if int(got.sum()) != valid_keys * BLOOM_K:
        raise AssertionError("bloom_count: masked indices were counted")
    del got
    ms = cuda_ms(lambda: bloom_block.bloom_count(idx, ncells), 10)
    plain_ms = cuda_ms(lambda: bloom_block.bloom_count_plain(idx, ncells), 3)
    valid = idx[idx != 2**31 - 1]
    library_ms = cuda_ms(lambda: torch.bincount(valid, minlength=ncells), 3)
    log(
        f"  bloom_count checked: {idx.numel()} indices ({valid.numel()} valid) "
        f"into {ncells} cells"
    )
    bound_bytes = 4 * idx.numel() + 4 * ncells  # indices read, counts written
    return kernel_row(
        "bloom_count", "bloom_count.cu", "src/repro/kernels/bloom_block.py:160",
        err, ms, plain_ms, bound_bytes, library_ms,
    )


def check_bloom_probe(structs, probes):
    """bloom_probe on the ingested plain and counting ``blocked_bloom`` states.

    The row carries the plain (uint8) state's times and bound; the
    counting (int16) state's are logged beside them.  A query reads its
    indices and cells only up to its first empty cell, so the bound
    counts the reads these queries need.
    """
    err, times = 0, {}
    group = cuda_lib.library("bloom_probe").bloom_probe_group()
    for label in ("blocked_bloom", "counting blocked_bloom"):
        cfg, state = structs[label][:2]
        idx = bloom_filter._indices(cfg, probes)
        cells = state.cells
        got = bloom_block.bloom_probe(cells, idx)
        err = max(err, max_abs_err([got], [bloom_block.bloom_probe_plain(cells, idx)]))
        if not bool(got[: probes.shape[0] // 2].all()):
            raise AssertionError(f"bloom_probe: {label} lost an inserted key")
        ms = cuda_ms(lambda: bloom_block.bloom_probe(cells, idx), 20)
        plain_ms = cuda_ms(lambda: bloom_block.bloom_probe_plain(cells, idx), 3)
        # a query stops at its first empty cell: the indices and cells read
        # up to there, in the cells' width, and one byte out
        needed = bloom.first_zero_probes(cells[idx.to(torch.int64)] != 0)
        reads = int(needed.sum())
        bound = reads * (4 + cells.element_size()) + idx.shape[0]
        times[label] = (ms, plain_ms, bound)
        # the kernel reads whole groups: each cell read a random 32-byte sector
        k = idx.shape[1]
        gathers = int(torch.clamp((needed + group - 1) // group * group, max=k).sum())
        log(
            f"  bloom_probe on {label} ({cells.dtype}): {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, bound {bound / H100_BYTES_PER_S * 1e3:.6f} ms; "
            f"{gathers} cell sectors gathered in groups of {group} ({reads} "
            f"up to the first empty cell), {gathers / ms / 1e6:.4f} G sectors/s, "
            f"{gathers * 32 / ms / 1e9:.4f} TB/s of sectors"
        )
    ms, plain_ms, bound = times["blocked_bloom"]
    return kernel_row(
        "bloom_probe", "bloom_probe.cu", "src/repro/kernels/bloom_block.py:96",
        err, ms, plain_ms, bound, None,
    )


def baseline_makers(n_total: int, device) -> dict:
    """bench_ssd's ``_mk_structs`` Bloom baselines at ratio ``RATIO``."""
    m_bits = bloom_m_bits(n_total)
    ram_bits = m_bits // RATIO
    cfg = bloom.BloomConfig(m_bits=m_bits, k=BLOOM_K)
    return {
        "ebf": lambda: bf_variants.ElevatorBloomFilter(
            cfg, buffer_capacity_bits=ram_bits // 64, device=device
        ),
        "bbf": lambda: bf_variants.BufferedBloomFilter(
            cfg, ram_bytes=ram_bits // 8, block_bytes=4096 * 8, page_bytes=512,
            device=device,
        ),
        "fbf": lambda: bf_variants.ForestBloomFilter(
            bits_per_element=BLOOM_K / np.log(2), ram_bytes=ram_bits // 8,
            total_elements=n_total, device=device,
        ),
    }


def baseline_io(struct, keys, lookups):
    """Ingest a baseline as bench_ssd does; its I/O logs and ingest time.

    Returns ``((ingest, uniform lookups, hit lookups) logs, ingest s)``.
    """
    step = keys.shape[0] // BATCHES
    ingest_s = 0.0
    for b in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        struct.insert(keys[b * step : (b + 1) * step])
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
    ingest = struct.io.snapshot()
    uniform, hits = lookups
    struct.lookup(uniform)
    mid = struct.io.snapshot()
    if not bool(struct.lookup(hits).all()):
        raise AssertionError(f"{type(struct).__name__}: false negative")
    return (ingest, mid.delta(ingest), struct.io.snapshot().delta(mid)), ingest_s


def qf_io(cfg, state, lookups):
    """The same logs for a QF structure of phase 3, from its ``IOCounters``."""
    uniform, hits = lookups
    ingest = filters.to_iolog(state.io)
    state, _ = filters.probe(cfg, state, uniform)
    mid = filters.to_iolog(state.io)
    state, hit = filters.probe(cfg, state, hits)
    if not bool(hit.all()):
        raise AssertionError(f"{type(cfg).__name__}: false negative")
    return ingest, mid.delta(ingest), filters.to_iolog(state.io).delta(mid)


def modeled_ops(n_total: int, logs) -> dict:
    """bench_ssd's modeled ops/s on the paper's SSD from the three logs."""
    ingest, uniform, hits = logs
    rate = lambda n, io: cost_model.modeled_throughput(n, io, cost_model.PAPER_SSD)
    return {
        "insert": rate(n_total, ingest),
        "lookup_uniform": rate(PAPER_LOOKUPS, uniform),
        "lookup_hit": rate(PAPER_LOOKUPS, hits),
    }


def differing_fields(a, b) -> list:
    """Names of the state fields that differ between two states."""
    la, lb = list(filters._leaves(a)), list(filters._leaves(b))
    if len(la) != len(lb):
        return ["<structure>"]
    return [na for (na, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]


# ---------------------------------------------------------------------------
# phases 8 and 9: the frozen tier
# ---------------------------------------------------------------------------


def frozen_spec(backend: str) -> dict:
    return dict(
        ram_q=RAM_Q, p=P_BITS, fanout=2, levels=FROZEN_LEVELS,
        frozen_below=FROZEN_BELOW, backend=backend,
    )


def peel_delta(before: dict) -> dict:
    return {k: fuse.peel_counts[k] - before[k] for k in before}


def freeze_watch():
    """A ``drive`` callback that records each insert batch that ran a peel:
    its batch, wall seconds, and the peel's attempts, rounds, host reads."""
    freezes, last = [], dict(fuse.peel_counts)

    def on_batch(b, seconds):
        d = peel_delta(last)
        if d["freezes"]:
            freezes.append(dict(batch=b + 1, seconds=seconds, **d))
        last.update(fuse.peel_counts)

    return freezes, on_batch


def drive_frozen(backend, keys, checkpoints):
    """Phase 3's stream into the frozen cascade; ``drive``'s results and
    the freezes it ran."""
    freezes, on_batch = freeze_watch()
    cfg, ingest_s, out, final = drive(
        "cascade", frozen_spec(backend), keys, checkpoints, on_batch
    )
    return cfg, ingest_s, out, final, freezes


def timed_host(fn):
    """``fn()`` with the card synchronised around it: (result, wall s, peel delta)."""
    before = dict(fuse.peel_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, peel_delta(before)


def check_xor_fuse(label, cfg, state, members, fresh) -> str:
    """No overflow, no false negative, fp rate at most twice 2**-fp_bits."""
    st = filters.stats(cfg, state)
    if bool(st["overflow"]):
        raise AssertionError(f"{label}: overflow (no seed peeled, or over capacity)")
    if not bool(filters.contains(cfg, state, members).all()):
        raise AssertionError(f"{label}: false negative")
    fp_rate = float(filters.contains(cfg, state, fresh).float().mean())
    bound = 2.0**-cfg.fp_bits
    if fp_rate > 2 * bound:
        raise AssertionError(f"{label}: fp rate {fp_rate} > 2 x {bound}")
    return (
        f"n {int(st['n'])}, n_unique {int(st['n_unique'])}, capacity "
        f"{cfg.capacity}, {st['slots']} cells, {st['bits_per_key']:.4f} bits/key; "
        f"fp rate {fp_rate:.4e} (2**-{cfg.fp_bits} = {bound:.4e})"
    )


def drive_xor_fuse(keys, fresh):
    """The ``xor_fuse`` family on its own under ``backend="pallas"``: a
    full-load ``make(keys=...)`` of the first ``XF_KEYS`` keys, ``grow``,
    and ``merge`` with a filter of the next ``XF_KEYS`` keys."""
    spec = dict(p=P_BITS, fp_bits=XF_FP_BITS, backend="pallas")
    first, second = keys[:XF_KEYS], keys[XF_KEYS : 2 * XF_KEYS]
    (cfg, state), s, d = timed_host(
        lambda: filters.make("xor_fuse", keys=first, **spec)
    )
    log(
        f"  xor_fuse make(keys=2**{XF_KEYS.bit_length() - 1}) at full load: "
        f"{s:.3f} s, {d}"
    )
    log(f"    {check_xor_fuse('xor_fuse', cfg, state, first, fresh)}")
    (gcfg, grown), s, d = timed_host(lambda: filters.grow(cfg, state))
    log(f"  grow to capacity {gcfg.capacity}: {s:.3f} s, {d}")
    ocfg, other = filters.make(
        "xor_fuse", keys=second, capacity=gcfg.capacity, **spec
    )
    if ocfg != gcfg:
        raise AssertionError(f"xor_fuse: {ocfg} != {gcfg}")
    merged, s, d = timed_host(lambda: filters.merge(gcfg, grown, other))
    log(f"  merge with the next {XF_KEYS} keys, at full load: {s:.3f} s, {d}")
    both = keys[: 2 * XF_KEYS]
    log(f"    {check_xor_fuse('merged xor_fuse', gcfg, merged, both, fresh)}")


def check_fuse(device, cfg, state, keys):
    """fuse_probe on level 1 of the frozen cascade, 2**22 queries: half
    keys of the 48 batches it holds, half uniform keys.  Its plain version
    is the route of the kernel before it took the hash: ``fuse_hash`` in
    PyTorch, then the three gathers."""
    fc, level = cfg.fuse_cfg(FROZEN_BELOW), state.levels[FROZEN_BELOW]
    held = keys.shape[0] // BATCHES * 48
    rng = np.random.default_rng(SEED + 4)
    half = PARITY_PROBES // 2
    pick = torch.from_numpy(rng.integers(0, held, half)).to(device)
    probes = torch.cat([keys[pick], uint32_keys(rng, half, device)])
    fq, fr, _ = canonical_queries(cfg, probes)
    args = (level.table, fq, fr, level.fuse_seed, fc.segment_length,
            fc.segment_count, fc.fp_bits)
    got = fuse_probe.fuse_probe(*args)
    err = max_abs_err([got], [fuse_probe.fuse_probe_plain(*args)])
    if not bool(got[:half].all()):
        raise AssertionError("fuse_probe: an inserted key was not found")
    ms = cuda_ms(lambda: fuse_probe.fuse_probe(*args), 20)
    plain_ms = cuda_ms(lambda: fuse_probe.fuse_probe_plain(*args), 5)
    # the hash alone, as the frozen lookups ran it in PyTorch before
    hash_ms = cuda_ms(lambda: fuse.fuse_hash(fc, fq, fr, level.fuse_seed), 5)
    log(
        f"  fuse_probe of {PARITY_PROBES} queries, hash included: {ms:.5f} ms; "
        f"fuse_hash alone in PyTorch {hash_ms:.5f} ms, plain (hash and "
        f"gathers) {plain_ms:.5f} ms; {3 * PARITY_PROBES} random cell sectors"
    )
    log(
        f"  fuse_probe checked on level 1's {level.table.numel()} cells "
        f"({int(level.n)} fingerprints); {int(got[half:].sum())} of {half} "
        "uniform keys hit"
    )
    # fingerprint pair read (2 x 4 bytes), three int32 cells gathered, one
    # byte written
    bound_bytes = PARITY_PROBES * (8 + 12 + 1)
    return kernel_row(
        "fuse_probe", "fuse_probe.cu", "src/repro/kernels/fuse_probe.py:109",
        err, ms, plain_ms, bound_bytes, None,
    )


def check_no_sync(cfg, state, keys) -> None:
    """The kernel-path probes of ``keys`` on the frozen cascade ``state``:
    ``ops.contains`` on its Q0, ``ops.cascade_lookup`` over its stack and
    ``ops.fuse_lookup`` on level 1, each run once more under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync raises."""
    qf_ix = [i for i in range(cfg.levels) if not cfg.is_frozen(i)]
    fz_ix = [i for i in range(cfg.levels) if cfg.is_frozen(i)]
    fc, level = cfg.fuse_cfg(FROZEN_BELOW), state.levels[FROZEN_BELOW]
    fq, fr = fingerprint.fingerprint(keys, *fc.canon, fc.seed, torch.int32)
    calls = {
        "ops.contains": lambda: ops.contains(cfg.q0_cfg, state.q0, keys),
        "ops.cascade_lookup": lambda: ops.cascade_lookup(
            (cfg.q0_cfg,) + tuple(cfg.level_cfg(i) for i in qf_ix),
            (state.q0,) + tuple(state.levels[i] for i in qf_ix),
            tuple(cfg.fuse_cfg(i) for i in fz_ix),
            tuple(state.levels[i] for i in fz_ix),
            keys,
        ),
        "ops.fuse_lookup": lambda: ops.fuse_lookup(fc, level, fq, fr),
    }
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log(f"  no host sync in {', '.join(calls)} (sync debug mode \"error\")")


def main(device: str = "cuda") -> int:
    if filters is None:
        print("chip_smoke.py: src/repro_torch is missing", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device(device)
    qf_kernels = {
        "qf_build_planes": qf_build.qf_build_planes,
        "qf_probe": qf_probe.qf_probe,
        "cascade_probe": cascade_probe.cascade_probe,
        "fingerprint": fingerprint.fingerprint,
    }
    bloom_kernels = {
        "bloom_count": bloom_block.bloom_count,
        "bloom_probe": bloom_block.bloom_probe,
    }
    frozen_kernels = {
        "qf_build_planes": qf_build.qf_build_planes,
        "cascade_probe": cascade_probe.cascade_probe,
        "fuse_probe": fuse_probe.fuse_probe,
        "fingerprint": fingerprint.fingerprint,
    }
    kernels = {**qf_kernels, **bloom_kernels, **frozen_kernels}
    phase_s = {}
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")
    launch_check(device)
    phase_s["build"] = time.perf_counter() - t0
    log(
        f"phase build: {len(logs)} kernels built in {build_s:.3f} s; each "
        "launched on small cases and equal to its plain version"
    )

    # 2. kernels (build and probe; the cascade probe runs on phase 3's state)
    t0 = time.perf_counter()
    rows = {}
    rows["qf_build_planes"], built = check_build(device)
    rows["qf_probe"], probe_keys = check_probe(device, built)
    rows["fingerprint"] = check_fingerprint(built[0], probe_keys)
    del built, probe_keys
    phase_s["kernels"] = time.perf_counter() - t0

    # 3. main path at the paper's scale
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n_total = RATIO * qf.QFConfig(q=RAM_Q, r=1).capacity
    mid_total = n_total // BATCHES * MID_BATCHES
    keys = uint32_keys(rng, n_total, device)
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    sample = keys[torch.from_numpy(rng.integers(0, n_total, PROBES)).to(device)]
    fresh = fresh_keys(rng, inserted_sorted, PROBES, device)
    del inserted_sorted
    mid_pick = torch.from_numpy(rng.integers(0, mid_total, PROBES)).to(device)
    mid_sample = keys[mid_pick]
    checkpoints = {MID_BATCHES: (mid_sample, fresh), BATCHES: (sample, fresh)}
    # bench_ssd's lookup sets for the modeled SSD numbers of phase 7
    rng_paper = np.random.default_rng(SEED + 3)
    uniform = rng_paper.integers(2**31, 2**32, PAPER_LOOKUPS).astype(np.uint32)
    pick = torch.from_numpy(rng_paper.integers(0, n_total, PAPER_LOOKUPS))
    paper_lookups = (
        torch.from_numpy(uniform.view(np.int32)).to(device),
        keys[pick.to(device)],
    )
    paper_logs = {}
    for k in kernels.values():
        k.launches = 0
    results = {}
    for name, spec in specs("pallas").items():
        cfg, ingest_s, out, final = drive(name, spec, keys, checkpoints)
        results[name] = (cfg, out)
        paper_logs[name] = qf_io(cfg, final, paper_lookups)
        del final
        log(
            f"phase main {name}: {n_total} keys ingested at "
            f"{n_total / ingest_s:.0f} keys/s ({ingest_s:.3f} s of wall time "
            "around the insert calls)"
        )
        for batches, (state, (hit, fp_hit), probe_ms) in out.items():
            fp_rate = float(fp_hit.float().mean())
            bound = union_bound(cfg, state)
            st = filters.stats(cfg, state)
            overflow = bool(st["overflow"])
            log(
                f"  after {batches} batches: probes {PROBES / probe_ms[0] * 1e3:.0f} "
                f"q/s (inserted), {PROBES / probe_ms[1] * 1e3:.0f} q/s (fresh), "
                f"median of {PROBE_REPS} calls by CUDA events; fp rate "
                f"{fp_rate:.3e} (union bound {bound:.3e}); overflow {overflow}"
            )
            stats = {
                k: v.tolist() if torch.is_tensor(v) else v for k, v in st.items()
            }
            log(f"  stats: {json.dumps(stats)}")
            log(f"  iolog: {vars(filters.to_iolog(state.io))}")
            if not bool(hit.all()):
                raise AssertionError(f"{name}: false negative among inserted keys")
            if fp_rate > 2 * bound:
                raise AssertionError(f"{name}: fp rate {fp_rate} > 2 x {bound}")
            if overflow:
                raise AssertionError(f"{name}: overflow")
    launches = {n: k.launches for n, k in qf_kernels.items()}
    log(f"  main-path launches: {launches}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the main path")
    phase_s["main"] = time.perf_counter() - t0

    # the fused cascade probe at the main path's size, on the mid-stream
    # state, where Q0 and a disk level both hold fingerprints
    t0 = time.perf_counter()
    cfg, out = results["cascade"]
    rows["cascade_probe"] = check_cascade(
        device, cfg, out[MID_BATCHES][0], keys[:mid_total]
    )
    del cfg, out
    phase_s["kernels"] += time.perf_counter() - t0

    # 4. the reference backend on the same stream
    t0 = time.perf_counter()
    for name, spec in specs("reference").items():
        _, ingest_s, out, _ = drive(name, spec, keys, checkpoints)
        _, k_out = results.pop(name)
        for batches, (state, hits, probe_ms) in out.items():
            k_state, k_hits, _ = k_out[batches]
            diff = differing_fields(k_state, state)
            same_hits = all(torch.equal(a, b) for a, b in zip(hits, k_hits))
            if diff or not same_hits:
                raise AssertionError(
                    f"{name} after {batches} batches: backends differ in "
                    f"{diff or 'hits'}"
                )
        log(
            f"phase backends {name}: reference equals pallas after "
            f"{MID_BATCHES} and {BATCHES} batches (planes, n, overflow, io, "
            f"hits); reference ingest {n_total / ingest_s:.0f} keys/s, probes "
            f"{PROBES / probe_ms[0] * 1e3:.0f} q/s (inserted, {BATCHES} batches)"
        )
        del k_out, out, state, k_state, hits, k_hits
        torch.cuda.empty_cache()
    phase_s["backends"] = time.perf_counter() - t0

    # 5. the Bloom families at bench_ssd's geometry, through both kernels
    t0 = time.perf_counter()
    probes = torch.cat([sample, fresh])  # half inserted keys, half fresh
    for k in kernels.values():
        k.launches = 0
    blooms, deleted = drive_bloom("pallas", keys, probes)
    check_deleted(blooms["counting blocked_bloom"][0], deleted, keys)
    bloom_launches = {n: k.launches for n, k in bloom_kernels.items()}
    log(f"  bloom-path launches: {bloom_launches}")
    for n, c in bloom_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the Bloom path")
    launches.update(bloom_launches)
    for label, (cfg, state, hit, ms, ingest_s) in blooms.items():
        cells = state.cells.numel()
        fp_rate = float(hit[PROBES:].float().mean())
        bound = bloom_fp_bound(n_total, cells)
        st = filters.stats(cfg, state)
        stats = {k: v.tolist() if torch.is_tensor(v) else v for k, v in st.items()}
        log(
            f"phase bloom {label}: {n_total} keys into {cells} cells at "
            f"{n_total / ingest_s:.0f} keys/s ({ingest_s:.3f} s of wall time "
            f"around the insert calls); {2 * PROBES} probes in {ms:.5f} ms, "
            f"{2 * PROBES / ms * 1e3:.0f} q/s (median of {PROBE_REPS} calls by "
            f"CUDA events); fp rate {fp_rate:.4e} (2 x bound {2 * bound:.4e}); "
            f"stats {json.dumps(stats)}"
        )
        if not bool(hit[:PROBES].all()):
            raise AssertionError(f"{label}: false negative among inserted keys")
        if fp_rate > 2 * bound:
            raise AssertionError(f"{label}: fp rate {fp_rate} > 2 x {bound}")
    log(
        f"  counting blocked_bloom: the first {DELETED_BATCHES} batches deleted; "
        f"every key of the other {BATCHES - DELETED_BATCHES} still hits, "
        f"n = {int(deleted.n)}"
    )
    phase_s["bloom"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["bloom_count"] = check_bloom_count(keys)
    rows["bloom_probe"] = check_bloom_probe(blooms, probes)
    phase_s["kernels"] += time.perf_counter() - t0

    # 6. the Bloom families under the reference backend
    t0 = time.perf_counter()
    ref_blooms, ref_deleted = drive_bloom("reference", keys, probes)
    for label in blooms:
        _, k_state, k_hit, *_ = blooms[label]
        _, r_state, r_hit, *_ = ref_blooms[label]
        diff = differing_fields(k_state, r_state)
        if diff or not torch.equal(k_hit, r_hit):
            raise AssertionError(f"{label}: backends differ in {diff or 'hits'}")
    diff = differing_fields(deleted, ref_deleted)
    if diff:
        raise AssertionError(f"counting blocked_bloom deletes: backends differ: {diff}")
    log(
        "phase bloom backends: reference equals pallas (cells, n, hits) for "
        f"{', '.join(blooms)}, and after the deletes; reference ingest "
        + ", ".join(f"{lb} {n_total / r[4]:.0f} keys/s" for lb, r in ref_blooms.items())
    )
    del blooms, deleted, ref_blooms, ref_deleted, k_state, r_state
    torch.cuda.empty_cache()
    phase_s["bloom_backends"] = time.perf_counter() - t0

    # 7. the paper's Bloom baselines, and the modeled SSD numbers of all five
    t0 = time.perf_counter()
    names = {"cascade": "cf", "buffered_qf": "bqf"}
    modeled = {names[n]: modeled_ops(n_total, logs) for n, logs in paper_logs.items()}
    card_keys_per_s = {}
    for name, make in baseline_makers(n_total, device).items():
        logs, ingest_s = baseline_io(make(), keys, paper_lookups)
        modeled[name] = modeled_ops(n_total, logs)
        card_keys_per_s[name] = n_total / ingest_s
        log(f"  {name}: ingest log {vars(logs[0])}")
        torch.cuda.empty_cache()
    bfs = ("ebf", "bbf", "fbf")
    best_bf = max(modeled[n]["insert"] for n in bfs)
    vs_best_bf = {n: modeled[n]["insert"] / best_bf for n in ("cf", "bqf")}
    vs_each_bf = {
        n: {b: modeled[n]["insert"] / modeled[b]["insert"] for b in bfs}
        for n in ("cf", "bqf")
    }
    log(
        "baselines: "
        + json.dumps(
            {
                "modeled_ops_per_s": modeled,
                "vs_best_bf": vs_best_bf,
                "vs_each_bf": vs_each_bf,
                "card_ingest_keys_per_s": card_keys_per_s,
            }
        )
    )
    phase_s["baselines"] = time.perf_counter() - t0

    # 8. the frozen tier: the same stream into a cascade with level 1 frozen,
    # then the xor_fuse family on its own
    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    cfg, ingest_s, f_out, f_final, freezes = drive_frozen("pallas", keys, checkpoints)
    fc = cfg.fuse_cfg(FROZEN_BELOW)
    qf_bytes = cfg.level_cfg(FROZEN_BELOW).size_bytes
    log(
        f"phase frozen cascade(levels={FROZEN_LEVELS}, frozen_below={FROZEN_BELOW}): "
        f"{n_total} keys ingested at {n_total / ingest_s:.0f} keys/s "
        f"({ingest_s:.3f} s of wall time around the insert calls); level 1 "
        f"frozen: table {fc.size_bytes} B ({fc.fp_bits}-bit cells, "
        f"{fc.segment_count} segments of {fc.segment_length}) + run {fc.run_bytes} B, "
        f"against {qf_bytes} B for the QF level it replaces "
        f"({1 - fc.size_bytes / qf_bytes:.4f} saved on the probe tier)"
    )
    for f in freezes:
        log(f"  freeze after batch {f['batch']}: {json.dumps(f)}")
    if not freezes:
        raise AssertionError("frozen cascade: no merge-down peeled a frozen level")
    for batches, (state, (hit, fp_hit), probe_ms) in f_out.items():
        fp_rate = float(fp_hit.float().mean())
        bound = union_bound(cfg, state)
        st = filters.stats(cfg, state)
        log(
            f"  after {batches} batches: probes {PROBES / probe_ms[0] * 1e3:.0f} "
            f"q/s (inserted), {PROBES / probe_ms[1] * 1e3:.0f} q/s (fresh), median "
            f"of {PROBE_REPS} calls by CUDA events ({probe_ms[0]:.5f} and "
            f"{probe_ms[1]:.5f} ms); fp rate {fp_rate:.4e} (bound {bound:.4e}); "
            f"level counts {st['level_counts'].tolist()}; "
            f"overflow {bool(st['overflow'])}"
        )
        log(f"  iolog: {vars(filters.to_iolog(state.io))}")
        if not bool(hit.all()):
            raise AssertionError("frozen cascade: false negative among inserted keys")
        if fp_rate > 2 * bound:
            raise AssertionError(f"frozen cascade: fp rate {fp_rate} > 2 x {bound}")
        if bool(st["overflow"]):
            raise AssertionError("frozen cascade: overflow")
    drive_xor_fuse(keys, fresh)
    frozen_launches = {n: k.launches for n, k in frozen_kernels.items()}
    log(f"  frozen-path launches: {frozen_launches}")
    for n, c in frozen_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the frozen path")
    launches["fuse_probe"] = frozen_launches["fuse_probe"]
    phase_s["frozen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["fuse_probe"] = check_fuse(device, cfg, f_final, keys)
    check_no_sync(cfg, f_final, sample)
    del f_final
    phase_s["kernels"] += time.perf_counter() - t0

    # 9. the frozen cascade under the reference backend
    t0 = time.perf_counter()
    _, ingest_s, r_out, _, r_freezes = drive_frozen("reference", keys, checkpoints)
    for batches, (state, hits, probe_ms) in r_out.items():
        k_state, k_hits, _ = f_out[batches]
        diff = differing_fields(k_state, state)
        same_hits = all(torch.equal(a, b) for a, b in zip(hits, k_hits))
        if diff or not same_hits:
            raise AssertionError(
                f"frozen cascade after {batches} batches: backends differ in "
                f"{diff or 'hits'}"
            )
    strip = lambda fs: [{k: v for k, v in f.items() if k != "seconds"} for f in fs]
    if strip(r_freezes) != strip(freezes):
        raise AssertionError(
            f"frozen cascade: the backends peeled differently: {r_freezes}"
        )
    log(
        f"phase frozen backends: reference equals pallas after {MID_BATCHES} and "
        f"{BATCHES} batches (fuse tables, runs, n, n_unique, fuse_seed, overflow, "
        f"QF planes, io, hits) and ran the same peels; reference ingest "
        f"{n_total / ingest_s:.0f} keys/s, probes {PROBES / probe_ms[0] * 1e3:.0f} "
        f"q/s (inserted, {BATCHES} batches)"
    )
    del f_out, r_out, state, k_state, hits, k_hits
    torch.cuda.empty_cache()
    phase_s["frozen_backends"] = time.perf_counter() - t0

    # 10. report
    for n, row in rows.items():
        row["launches"] = launches[n]
        if row["max_abs_err"] != 0:
            raise AssertionError(f"{n} disagrees with its plain version")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phase_s.items()}))
    log(f"peak device memory allocated: {torch.cuda.max_memory_allocated()} bytes")
    log(json.dumps({"kernels": list(rows.values())}))
    log(card_line())
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    log(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
