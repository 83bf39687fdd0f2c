"""The port's kernel wrappers, plain versions and oracles against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
CUDA kernels themselves are held against those plain versions on the
card by ``chip_smoke.py``, whose cluster walk (the bytes of the probes'
bound) is tested here too.  The JAX side runs its Pallas kernels in
interpret mode at tiny shapes, as ``tests/test_kernels.py`` does, and
its pure-jnp oracles in ``repro.kernels.ref``.  Every comparison is
exact.
"""

import functools
import re
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quotient_filter as jqf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quotient_filter as tqf
from repro_torch.kernels import cascade_probe, dispatch, ops, qf_build, qf_decode, qf_probe
from repro_torch.kernels import ref as tref


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()  # its cluster walk counts the probes' bound


def _i32(x):
    return x.to(torch.int32)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)


def _t(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


@functools.lru_cache(maxsize=None)
def _filled(q, r, n, seed=0):
    """The same keys in a JAX and a port QF at load up to 1.0."""
    jcfg = jqf.QFConfig(q=q, r=r, max_load=1.0)
    tcfg = tqf.QFConfig(q=q, r=r, max_load=1.0)
    keys = _keys(seed, n)
    js = jqf.insert(jcfg, jqf.empty(jcfg), jnp.asarray(keys))
    ts = tqf.insert(tcfg, tqf.empty(tcfg, "cpu"), _t(keys))
    return jcfg, tcfg, js, ts, keys


# compiled: run eagerly the (B x 2W) oracles take seconds op by op
_jax_probe_ref = jax.jit(jref.probe_ref, static_argnums=6)
_jax_cascade_probe_ref = jax.jit(jref.cascade_probe_ref, static_argnums=3)

# the filters every test draws from: (q, r, n), n = 0.74 * 2**q
SMALL, WIDE = (8, 8, 190), (10, 31, 760)


def _jplanes(js):
    planes = (js.rem, js.occ, js.shf, js.con)
    return tuple(jnp.asarray(p).astype(jnp.int32) for p in planes)


def _tplanes(ts):
    return (ts.rem, ts.occ, ts.shf, ts.con)


def _sorted_stream(tcfg, keys):
    fq, fr = tqf.fingerprints(tcfg, _t(keys))
    return tqf._pad_sort(fq, fr, torch.ones(fq.shape, dtype=torch.bool))


def test_build_plain_matches_interpreted_kernel_and_oracles():
    jcfg, tcfg, js, ts, keys = _filled(*WIDE)
    fq, fr = _sorted_stream(tcfg, keys)
    n = torch.tensor(keys.shape[0], dtype=torch.int32)
    nn, valid, pos, _ = tqf.probe_positions(tcfg, fq, n)
    rem, occ, shf, con = qf_build.qf_build_planes(
        _i32(pos), _i32(fq), _i32(fr), nn, tcfg.total_slots
    )
    assert qf_build.qf_build_planes.launches == 0  # CPU tensors: no launch
    for a, b in zip((rem, occ, shf, con), _tplanes(ts)):
        assert torch.equal(a, b)

    # the JAX Pallas kernel, interpreted, writes the same planes
    jfq, jfr = jqf.fingerprints(jcfg, jnp.asarray(keys))
    jfq, jfr = jqf._pad_sort(jfq, jfr, jnp.ones(jfq.shape, bool))
    jst = jops.build_sorted(jcfg, jfq, jfr, keys.shape[0], mode="interpret")
    for f, a, b in zip(jst._fields, jst, ops.build_sorted(tcfg, fq, fr, n)):
        b = b.numpy().view(np.uint32) if f == "rem" else b.numpy()
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)

    # the oracle ref.build_ref, in both packages
    idx = torch.arange(fq.shape[0])
    con_b = (idx > 0) & (fq == torch.roll(fq, 1)) & valid
    shf_b = (pos != fq) & valid
    spos = torch.where(valid, pos, tqf.INT32_MAX)
    t_rem, t_meta, t_occ = tref.build_ref(
        tcfg.total_slots, spos, fq, fr.to(torch.int32), con_b, shf_b
    )
    j_rem, j_meta, j_occ = jref.build_ref(
        jcfg.total_slots,
        jnp.asarray(spos.numpy().astype(np.int32)),
        jnp.asarray(fq.numpy().astype(np.int32)),
        jnp.asarray(fr.to(torch.int32).numpy()),
        jnp.asarray(con_b.numpy()),
        jnp.asarray(shf_b.numpy()),
    )
    for a, b in ((j_rem, t_rem), (j_meta, t_meta), (j_occ, t_occ)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert torch.equal(t_rem, rem)
    assert torch.equal(t_meta, con.to(torch.int32) | (shf.to(torch.int32) << 1))


@pytest.mark.parametrize("q,r,n", [SMALL, WIDE])
def test_probe_plain_matches_oracles(q, r, n):
    jcfg, tcfg, js, ts, keys = _filled(q, r, n)
    probes = np.concatenate([keys, _keys(q + 100, 2 * n)])
    tq, tr = tqf.fingerprints(tcfg, _t(probes))
    jq, jr = jqf.fingerprints(jcfg, jnp.asarray(probes))
    present = qf_probe.qf_probe(*_tplanes(ts), _i32(tq), _i32(tr))
    assert qf_probe.qf_probe.launches == 0
    exact = np.asarray(jqf.lookup_exact(jcfg, js, jq, jr))
    np.testing.assert_array_equal(present.numpy(), exact)
    np.testing.assert_array_equal(ops.lookup(tcfg, ts, tq, tr).numpy(), exact)
    # the JAX oracle and its port at a window wide enough that no cluster
    # leaves it, and (once) at one most clusters leave
    for window in (8, 256) if q == SMALL[0] else (256,):
        jp, jo = _jax_probe_ref(*_jplanes(js), jq, jr.astype(jnp.int32), window)
        tp, to = tref.probe_ref(*_tplanes(ts), tq, tr, window)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(present.numpy(), tp.numpy())
    assert not to.any()


def test_probe_plain_matches_interpreted_kernel():
    jcfg, tcfg, js, ts, keys = _filled(*WIDE)
    probes = np.concatenate([keys[:300], _keys(9, 300)])
    jq, jr = jqf.fingerprints(jcfg, jnp.asarray(probes))
    got = jops.lookup(jcfg, js, jq, jr, mode="interpret")
    np.testing.assert_array_equal(
        np.asarray(got), ops.contains(tcfg, ts, _t(probes)).numpy()
    )


def test_walk_spans_cover_the_cluster():
    jcfg, tcfg, js, ts, keys = _filled(*SMALL)
    fq, fr = tqf.fingerprints(tcfg, _t(keys))
    present, first, last, run = chip_smoke.walk_spans(_tplanes(ts), fq, fr)
    assert present.all()
    assert (first <= fq).all() and (fq <= last).all()
    assert not ts.shf[first].any()  # each walk starts at a cluster's start
    assert (first <= run).all() and (run <= last).all()  # the run inside it
    # the walks' bytes: three metadata bytes per covered slot, at least one
    # per query, at most the three metadata planes
    walked = chip_smoke.walked_bytes(_tplanes(ts), fq, fr)
    assert torch.unique(fq).numel() <= walked <= 3 * tcfg.total_slots


def test_overflowed_state_marks_walks_past_the_end():
    tcfg = tqf.QFConfig(q=5, r=8, slack=2)
    keys = _keys(4, 60)
    ts = tqf.insert(tcfg, tqf.empty(tcfg, "cpu"), _t(keys))
    assert bool(ts.overflow)
    fq, fr = tqf.fingerprints(tcfg, _t(keys))
    _, _, last, _ = chip_smoke.walk_spans(_tplanes(ts), fq, fr)
    # walks that run off the planes stop at the last slot, so the bytes
    # counted for them stay inside the planes
    assert (last == tcfg.total_slots - 1).any()
    assert (last < tcfg.total_slots).all()
    # the kernel's plain version still answers, and ops.lookup with it
    got = qf_probe.qf_probe(*_tplanes(ts), _i32(fq), _i32(fr))
    assert torch.equal(got, ops.lookup(tcfg, ts, fq, fr))


def _cascade_levels():
    """Three QFs of one fingerprint width p = 16, the last one empty."""
    out = [_filled(7, 9, 90)[:4], _filled(*SMALL)[:4]]
    jcfg, tcfg = jqf.QFConfig(q=9, r=7), tqf.QFConfig(q=9, r=7)
    return out + [(jcfg, tcfg, jqf.empty(jcfg), tqf.empty(tcfg, "cpu"))]


def test_cascade_plain_matches_oracles():
    levels = _cascade_levels()
    inserted = [_keys(0, 90)[:40], _keys(0, SMALL[2])[:40]]  # into levels 0, 1
    probes = np.concatenate([*inserted, _keys(3, 80)])
    jq, jr, tq, tr = [], [], [], []
    for jcfg, tcfg, _, _ in levels:
        a, b = jqf.fingerprints(jcfg, jnp.asarray(probes))
        jq.append(a)
        jr.append(b.astype(jnp.int32))
        c, d = tqf.fingerprints(tcfg, _t(probes))
        tq.append(c)
        tr.append(d)
    # the kernel reads each query once, in the canonical split of p = 16
    canon = tqf.QFConfig(q=1, r=15)
    cq, cr = tqf.fingerprints(canon, _t(probes))
    hit = cascade_probe.cascade_probe(
        [_tplanes(ts) for *_, ts in levels],
        [ts.n for *_, ts in levels],
        [t.r for _, t, _, _ in levels],
        _i32(cq),
        _i32(cr),
        canon.r,
    )
    assert cascade_probe.cascade_probe.launches == 0
    jh, jo = _jax_cascade_probe_ref(
        [_jplanes(js) for _, _, js, _ in levels], jq, jr, 512
    )
    th, to = tref.cascade_probe_ref([_tplanes(ts) for *_, ts in levels], tq, tr, 512)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jh), hit.numpy())
    assert not to.any()
    assert (hit[:80] != 0).all() and not (hit >> 2).any()

    # ops.cascade_lookup hashes once and re-splits per level: the same hits
    # as one plain lookup per level
    hits = ops.cascade_lookup(
        [t for _, t, _, _ in levels], [s for *_, s in levels], (), (), _t(probes)
    )
    for lvl, (_, tcfg, _, ts) in enumerate(levels):
        want = ops.contains(tcfg, ts, _t(probes)) & (ts.n > 0)
        assert torch.equal(hits[lvl], want)
        assert torch.equal(hits[lvl], ((hit >> lvl) & 1) > 0)


def _interleaved_levels():
    """Five QFs of p = 16 whose counts run [live, 0, live, 0, 0], as the
    main path's cascade stands mid-stream."""
    def empty(q):
        jcfg, tcfg = jqf.QFConfig(q=q, r=16 - q), tqf.QFConfig(q=q, r=16 - q)
        return jcfg, tcfg, jqf.empty(jcfg), tqf.empty(tcfg, "cpu")

    return [_filled(7, 9, 90)[:4], empty(8), _filled(9, 7, 380)[:4], empty(10),
            empty(11)]


@pytest.mark.parametrize("case", ["interleaved", "stale_occ"])
def test_cascade_reads_no_level_whose_count_is_zero(case):
    levels = _interleaved_levels()
    inserted = [_keys(0, 90)[:40], _keys(0, 380)[:40]]  # into levels 0 and 2
    probes = np.concatenate([*inserted, _keys(5, 80)])
    counts = [ts.n for *_, ts in levels]
    if case == "stale_occ":  # level 2 keeps its planes but counts nothing
        counts[2] = torch.zeros((), dtype=torch.int32)
    canon = tqf.QFConfig(q=1, r=15)
    cq, cr = tqf.fingerprints(canon, _t(probes))
    hit = cascade_probe.cascade_probe(
        [_tplanes(ts) for *_, ts in levels],
        counts,
        [t.r for _, t, _, _ in levels],
        _i32(cq),
        _i32(cr),
        canon.r,
    )
    assert cascade_probe.cascade_probe.launches == 0
    # the JAX oracle reads every level's planes; an empty level's are zero
    jq, jr = [], []
    for jcfg, *_ in levels:
        a, b = jqf.fingerprints(jcfg, jnp.asarray(probes))
        jq.append(a)
        jr.append(b.astype(jnp.int32))
    jh, jo = _jax_cascade_probe_ref(
        [_jplanes(js) for _, _, js, _ in levels], jq, jr, 512
    )
    assert not np.asarray(jo).any()
    want = np.asarray(jh)
    assert (want[:40] & 1).all() and (want[40:80] & 4).all()
    assert not (want & 0b11010).any()  # the empty levels hold nothing
    if case == "stale_occ":
        want = want & ~4  # a count of 0 answers no, whatever occ holds
    np.testing.assert_array_equal(hit.numpy(), want)


def test_cascade_rejects_mixed_widths_and_too_many_levels():
    levels = _cascade_levels()
    with pytest.raises(ValueError):
        ops.cascade_lookup(
            [levels[0][1], tqf.QFConfig(q=8, r=10)],  # p = 16 and p = 18
            [levels[0][3], levels[1][3]],
            (),
            (),
            _t(_keys(1, 4)),
        )
    plane = _tplanes(levels[0][3])
    n = levels[0][3].n
    fq = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cascade_probe.cascade_probe([plane] * 33, [n] * 33, [9] * 33, fq, fq, 15)
    with pytest.raises(TypeError):  # the kernels take int32 fingerprints
        cascade_probe.cascade_probe([plane], [n], [9], fq.long(), fq.long(), 15)
    with pytest.raises(ValueError):  # one count per level
        cascade_probe.cascade_probe([plane] * 2, [n], [9] * 2, fq, fq, 15)
    with pytest.raises(TypeError):  # counts are the states' int32 n
        cascade_probe.cascade_probe([plane], [n.long()], [9], fq, fq, 15)
    with pytest.raises(ValueError):  # ... as 0-d tensors
        cascade_probe.cascade_probe([plane], [n.reshape(1)], [9], fq, fq, 15)


def test_dispatch_follows_the_inputs_device():
    cpu = torch.zeros(3)
    assert dispatch.use_kernel(cpu, cpu) is False
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        dispatch.use_kernel(cpu, meta)
    with pytest.raises(TypeError):
        dispatch.require(cpu, "x", torch.int64)
    with pytest.raises(ValueError):
        dispatch.require(torch.zeros(4, 2)[:, 0], "x", torch.float32)


# Shapes the tiled build (4096-slot tiles) and the bit-plane walk (32-slot
# words) find hard: (q, slack, items / 2**q, valid items short of all).
# Load 0.95 puts clusters across tile and word ends; a slack of 1000 gives
# a slot count that is no multiple of 4096 or of 32; "fewer_valid" builds
# from the first items only; "dropped_past_end" has more items than slots.
HARD = {
    "load_0.95": (13, 1024, 0.95, 0),
    "ragged_slots": (12, 1000, 0.9, 0),
    "fewer_valid": (13, 1024, 0.9, 700),
    "dropped_past_end": (13, 16, 1.02, 0),
}


def _hard_items(q, slack, load, short, seed=11):
    """Sorted (fq, fr) items at ``load``, 12 of them at bucket 4090 (a run
    across slot 4096), the first ``items - short`` valid; numpy arrays,
    and the numpy probe positions of the valid ones."""
    rng = np.random.default_rng(seed)
    n_items = int(load * 2**q)
    fq = np.sort(np.concatenate([rng.integers(0, 2**q, n_items - 12), [4090] * 12]))
    fr = rng.integers(0, 2**10, n_items)
    o = np.lexsort((fr, fq))
    fq, fr = fq[o], fr[o]
    n = n_items - short
    idx = np.arange(n_items)
    pos = idx + np.maximum.accumulate(np.where(idx < n, fq - idx, -(2**31)))
    return fq, fr, n, pos


def _hard_build(case):
    q, slack, load, short = HARD[case]
    cfg = tqf.QFConfig(q=q, r=10, slack=slack)
    fq, fr, n, pos = _hard_items(q, slack, load, short)
    tq, tr = torch.from_numpy(fq), torch.from_numpy(fr)
    nn, _, tpos, _ = tqf.probe_positions(cfg, tq, n)
    np.testing.assert_array_equal(tpos[:n].numpy(), pos[:n])
    planes = qf_build.qf_build_planes(_i32(tpos), _i32(tq), _i32(tr), nn, cfg.total_slots)
    return cfg, (fq, fr, n, pos), planes


@pytest.mark.parametrize("case", sorted(HARD))
def test_build_plain_matches_oracle_at_hard_shapes(case):
    cfg, (fq, fr, n, pos), planes = _hard_build(case)
    t = cfg.total_slots
    assert t % 4096 or case != "ragged_slots"
    valid = np.arange(fq.shape[0]) < n
    dropped = valid & (pos >= t)
    assert dropped.any() == (case == "dropped_past_end")
    # the JAX oracle, from numpy inputs
    con_b = valid & (np.arange(fq.shape[0]) > 0) & (fq == np.roll(fq, 1))
    shf_b = valid & (pos != fq)
    j_rem, j_meta, j_occ = jref.build_ref(
        t,
        jnp.asarray(np.where(valid, pos, 2**31 - 1).astype(np.int32)),
        jnp.asarray(np.where(valid, fq, 2**31 - 1).astype(np.int32)),
        jnp.asarray(fr.astype(np.int32)),
        jnp.asarray(con_b),
        jnp.asarray(shf_b),
    )
    rem, occ, shf, con = planes
    np.testing.assert_array_equal(np.asarray(j_rem), rem.numpy())
    np.testing.assert_array_equal(
        np.asarray(j_meta), (con.to(torch.int32) | (shf.to(torch.int32) << 1)).numpy()
    )
    np.testing.assert_array_equal(np.asarray(j_occ) > 0, occ.numpy())
    # a dropped item's bucket is still occupied
    assert occ[torch.from_numpy(fq[dropped])].all()
    assert bool(shf[4096])  # the run at 4090 crosses the first tile's end
    assert shf[torch.arange(32, t, 32)].any()  # clusters across word ends


@pytest.mark.parametrize("case", sorted(HARD))
def test_probe_plain_matches_oracle_at_hard_shapes(case):
    cfg, (fq, fr, n, _), planes = _hard_build(case)
    rng = np.random.default_rng(12)
    members = rng.integers(0, n, 600)
    pq = np.concatenate([fq[members], rng.integers(0, cfg.m, 600)])
    pr = np.concatenate([fr[members], rng.integers(0, 2**10, 600)])
    tq, tr = torch.from_numpy(pq), torch.from_numpy(pr)
    present = qf_probe.qf_probe(*planes, _i32(tq), _i32(tr))
    # the JAX package's exact lookup on the same planes
    rem, occ, shf, con = (p.numpy() for p in planes)
    jcfg = jqf.QFConfig(q=cfg.q, r=cfg.r, slack=cfg.slack)
    jstate = jqf.QFState(
        rem=jnp.asarray(rem.view(np.uint32)), occ=jnp.asarray(occ),
        shf=jnp.asarray(shf), con=jnp.asarray(con), n=jnp.int32(n),
        overflow=jnp.asarray(case == "dropped_past_end"),
    )
    exact = np.asarray(
        jqf.lookup_exact(jcfg, jstate, jnp.asarray(pq.astype(np.int32)),
                         jnp.asarray(pr.astype(np.uint32)))
    )
    np.testing.assert_array_equal(present.numpy(), exact)
    # and the cluster walk the kernels run
    walked, _, _, _ = chip_smoke.walk_spans(planes, tq, tr)
    np.testing.assert_array_equal(walked.numpy(), exact)
    if case != "dropped_past_end":  # an overflowed table may lose members
        assert exact[:600].all()


def test_chip_smoke_cases_reach_their_branches():
    """The small phase-1 cases of the QF kernels are what they claim."""
    cases = dict(chip_smoke.build_cases("cpu"))
    pos, fq, fr, nn, t = cases["load 0.95, across a tile's end"]
    assert t % 4096 and t > 4096
    rem, occ, shf, con = qf_build.qf_build_planes(pos, fq, fr, nn, t)
    assert bool(shf[4096]) and bool(con[4096])  # a cluster and a run cross 4096
    assert int(cases["fewer valid than items"][3]) < fq.shape[0]
    assert int(cases["none valid"][3]) == 0
    pos, fq, fr, nn, t = cases["items dropped past the last slot"]
    assert bool((pos >= t).any())
    probes = {label: (p, q) for label, p, q, _ in chip_smoke.probe_cases(
        "cpu", cases["load 0.95, across a tile's end"])}
    n_probes = {label: q.shape[0] for label, (_, q) in probes.items()}
    assert n_probes["no query"] == 0 and n_probes["duplicates"] % 256
    planes, q = probes["sparse queries"]
    assert q.shape[0] * qf_probe.DENSE < planes[0].shape[0]  # the byte walk
    planes, q = probes["planes off a 16-byte boundary"]
    assert planes[1].storage_offset() == 1
    planes, q = probes["overflowed state"]
    assert planes[0].shape[0] % 32 and q.shape[0] * qf_probe.DENSE >= planes[0].shape[0]
    # the probe scan's cases: tiles, look-back windows, overflow, no rows valid
    tile = qf_build.SCAN_TILE
    scans = dict(chip_smoke.scan_cases("cpu"))
    fq, n, t = scans["one cluster over 100 tiles"]
    assert fq.shape[0] > 3 * 32 * tile and bool((fq == fq[0]).all())  # 32-tile windows
    for label, (fq, n, t) in scans.items():
        pos, overflow = qf_build.qf_positions(fq, n, t)
        assert bool(overflow) == label.startswith("overflow"), label
    assert int(scans["n = 0"][1]) == 0
    assert int(scans["fewer valid than rows"][1]) < scans["fewer valid than rows"][0].shape[0]
    assert [scans[f"tile{d}"][0].shape[0] - tile for d in (" - 1", "", " + 1")] == [-1, 0, 1]
    # the span append's cases: carries, runs, empty spans, tiles, dropped items
    spans = {label: (args, want) for label, args, _, want in chip_smoke.span_cases("cpu")}
    (fq, fr, k, n, overflow, lp, lf), _ = spans["first quotient continues last_fq"]
    assert int(fq[0]) == int(lf)
    (fq, _, k, _, _, lp, lf), _ = spans["one cluster across tiles, from inside it"]
    assert fq.shape[0] > 2 * tile and int(k) == fq.shape[0] and bool((fq == lf).all())
    assert int(spans["k = 0"][0][2]) == 0
    args, want = spans["items dropped past the last slot"]
    assert bool(want[5]) and not bool(args[4])  # this span overflows the slots


# the kernel path's families, small: (family, spec, keys for make)
HASHED = {
    "qf": ("qf", dict(q=9, r=14)),
    "buffered_qf": ("buffered_qf", dict(ram_q=7, disk_q=10, p=22)),
    "cascade": ("cascade", dict(ram_q=6, p=22, fanout=2, levels=2)),
    "frozen cascade": ("cascade", dict(ram_q=7, p=30, fanout=2, levels=3,
                                       frozen_below=1)),
    "xor_fuse": ("xor_fuse", dict(capacity=400, p=39)),
}


@pytest.mark.parametrize("name", sorted(HASHED))
def test_kernel_path_hashes_keys_through_the_fingerprint_kernel(name, monkeypatch):
    """Under ``backend="pallas"`` every insert hashes its keys through the
    ``fingerprint`` wrapper into int64 pairs, every probe into int32 pairs,
    and a frozen level takes those pairs into ``fuse_probe``; the answers
    and states equal the ``"reference"`` spelling's."""
    from repro_torch import filters as tf
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import fuse_probe

    family, spec = HASHED[name]
    keys = _t(_keys(30, 480))
    probes = torch.cat([keys[::3], _t(_keys(31, 300))])
    make_kw = dict(keys=keys[:300]) if family == "xor_fuse" else {}
    calls = []

    def spy(fn, label):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append((label, out[0].dtype if label == "fingerprint" else None))
            return out
        return wrapped

    seen = {}
    for backend in ("reference", "pallas"):
        if backend == "pallas":
            fp_spy = spy(kfp.fingerprint, "fingerprint")
            monkeypatch.setattr(kfp, "fingerprint", fp_spy)
            monkeypatch.setattr(ops, "fingerprint", fp_spy)
            monkeypatch.setattr(ops, "fuse_probe", spy(fuse_probe.fuse_probe, "fuse"))
        cfg, st = tf.make(family, device="cpu", backend=backend, **spec, **make_kw)
        if family != "xor_fuse":
            for b in range(0, 480, 96):
                st = tf.insert(cfg, st, keys[b : b + 96])
        inserts = list(calls)
        hit = tf.contains(cfg, st, probes)
        seen[backend] = (tf.to_numpy(cfg, st), hit, inserts, calls[len(inserts):])
    (ref_state, ref_hit, _, _), (state, hit, inserts, lookups) = seen.values()
    members = 100 if family == "xor_fuse" else 160  # keys[::3] inserted
    assert torch.equal(hit, ref_hit) and hit[:members].all()
    for a, b in zip(ref_state, state):
        np.testing.assert_array_equal(a, b)
    if family == "xor_fuse":  # construction keeps the plain hash
        assert inserts == []
    else:
        assert inserts and set(inserts) == {("fingerprint", torch.int64)}
    want_probe = {"buffered_qf": 2}.get(name, 1)
    assert lookups.count(("fingerprint", torch.int32)) == want_probe
    frozen = {"frozen cascade": 2, "xor_fuse": 1}.get(name, 0)  # levels 1 and 2
    assert lookups.count(("fuse", None)) == frozen
    assert len(lookups) == want_probe + frozen
    if name == "frozen cascade":  # the frozen level holds keys
        assert int(tf.stats(cfg, st)["level_counts"][1]) > 0


# Streams for the probe scan: (quotients, valid rows or None for all,
# total slots), the quotients sorted.  The scan works in 8192-row
# tiles (``qf_build.SCAN_TILE``); a cluster that covers every row crosses
# every tile end, and a packed tail overflows the slots.
def _scan_stream(case):
    tile = qf_build.SCAN_TILE
    rng = np.random.default_rng(21)

    def uniform(rows, buckets):
        return np.sort(rng.integers(0, buckets, rows))

    return {
        "n = 0": (uniform(300, 400), 0, 1424),
        "n = len": (uniform(300, 400), None, 1424),
        "fewer valid than rows": (uniform(300, 400), 170, 1424),
        "one cluster over the whole stream": (np.full(3 * tile + 5, 7), None, 4 * tile),
        "overflow past the last slot": (uniform(700, 64) + 500, None, 1000),
        "length 1": (np.array([9]), None, 16),
        "tile - 1": (uniform(tile - 1, 2 * tile), None, 2 * tile + 1024),
        "tile": (uniform(tile, tile), None, tile + 1024),
        "tile + 1": (uniform(tile + 1, tile), 4000, tile + 1024),
    }[case]


SCAN_CASES = [
    "n = 0", "n = len", "fewer valid than rows", "one cluster over the whole stream",
    "overflow past the last slot", "length 1", "tile - 1", "tile", "tile + 1",
]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_positions_plain_matches_jax_cummax_and_a_loop(case):
    """``qf_positions`` (its plain version on the CPU) against the JAX
    package's expression ``idx + lax.cummax(where(valid, fq - idx,
    -INT32_MAX))`` on every row, and against the probe recurrence
    ``pos[i] = max(pos[i-1] + 1, fq[i])`` over the valid rows; the
    overflow flag against a valid row at or past the last slot."""
    fq, n, total = _scan_stream(case)
    n = fq.shape[0] if n is None else n
    pos, overflow = qf_build.qf_positions(
        torch.from_numpy(fq.astype(np.int32)), torch.tensor(n, dtype=torch.int32), total
    )
    assert pos.dtype == torch.int32 and overflow.dtype == torch.bool
    jq = jnp.asarray(fq.astype(np.int32))
    idx = jnp.arange(fq.shape[0], dtype=jnp.int32)
    valid = idx < n
    jpos = idx + jax.lax.cummax(jnp.where(valid, jq - idx, -jqf.INT32_MAX))
    np.testing.assert_array_equal(np.asarray(jpos), pos.numpy())
    assert bool(overflow) == bool(jnp.any(valid & (jpos >= total)))
    loop = np.zeros(n, dtype=np.int64)
    for i in range(n):
        loop[i] = fq[i] if i == 0 else max(loop[i - 1] + 1, fq[i])
    np.testing.assert_array_equal(loop, pos.numpy()[:n])
    assert bool(overflow) == bool((loop >= total).any())
    assert bool(overflow) == (case == "overflow past the last slot")


def test_build_sorted_routes_through_qf_positions(monkeypatch):
    """``ops.build_sorted`` takes its positions from ``qf_positions``, not
    from the plain path's ``probe_positions`` (patched to raise here),
    and still equals the JAX package's build."""
    calls = []

    def spy(*args):
        calls.append(args[0].dtype)
        return qf_build.qf_positions(*args)

    def refuse(*args, **kw):
        raise AssertionError("the kernel path called probe_positions")

    streams = []
    for q, r, n in (SMALL, WIDE):
        jcfg, tcfg, _, _, keys = _filled(q, r, n)
        jfq, jfr = jqf.fingerprints(jcfg, jnp.asarray(keys))
        jfq, jfr = jqf._pad_sort(jfq, jfr, jnp.ones(jfq.shape, bool))
        streams.append((n, jcfg, tcfg, _sorted_stream(tcfg, keys), (jfq, jfr)))
    monkeypatch.setattr(ops, "qf_positions", spy)
    monkeypatch.setattr(tqf, "probe_positions", refuse)
    for n, jcfg, tcfg, (fq, fr), (jfq, jfr) in streams:
        for count in (n, n - 37, 0):
            got = ops.build_sorted(tcfg, fq, fr, count)
            want = jops.build_sorted(jcfg, jfq, jfr, count, mode="interpret")
            for f, a, b in zip(want._fields, want, got):
                b = b.numpy().view(np.uint32) if f == "rem" else b.numpy()
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
    assert calls == [torch.int32] * 6


# small specs of the QF families whose deletes rebuild their tables
DELETE_SPECS = {
    "qf": dict(q=9, r=14),
    "buffered_qf": dict(ram_q=7, disk_q=10, p=22),
    "cascade": dict(ram_q=6, p=22, fanout=2, levels=2),
}


@pytest.mark.parametrize("name", sorted(DELETE_SPECS))
def test_kernel_path_delete_rebuilds_through_ops_build_sorted(name, monkeypatch):
    """Under ``backend="pallas"`` a delete rebuilds each table it touches
    with ``ops.build_sorted`` (so through ``qf_positions`` and
    ``qf_build_planes`` on the card), and the state equals the JAX
    package's delete of the same keys."""
    from repro import filters as jf
    from repro_torch import filters as tf

    spec = dict(DELETE_SPECS[name], backend="pallas")
    keys = _keys(40, 300)
    gone = np.concatenate([keys[:60], keys[:10], _keys(41, 20)])
    jcfg, jst = jf.make(name, **spec)
    tcfg, tst = tf.make(name, device="cpu", **spec)
    for b in range(0, 300, 96):
        jst = jf.insert(jcfg, jst, jnp.asarray(keys[b : b + 96]))
        tst = tf.insert(tcfg, tst, _t(keys[b : b + 96]))
    builds = []

    def spy(*args):
        builds.append(args[0])
        return build(*args)

    build = ops.build_sorted
    monkeypatch.setattr(ops, "build_sorted", spy)
    jst = jax.jit(jf.delete, static_argnums=0)(jcfg, jst, jnp.asarray(gone))
    tst = tf.delete(tcfg, tst, _t(gone))
    assert builds  # every table the delete touched was rebuilt on the kernel path
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    tleaves = tf.to_numpy(tcfg, tst)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert not tf.contains(tcfg, tst, _t(keys[60:])).logical_not().any()


def test_scan_tile_matches_the_cuda_source():
    """The wrapper's ``SCAN_TILE`` (the scratch's tiles, the tests' tile
    edges) is the tile ``csrc/qf_scan.cuh`` scans."""
    text = (Path(qf_build.__file__).parents[1] / "csrc" / "qf_scan.cuh").read_text()
    consts = {
        name: int(value)
        for name, value in re.findall(r"constexpr int (SCAN_\w+) = (\d+);", text)
    }
    assert consts["SCAN_THREADS"] * consts["SCAN_ROUNDS"] == qf_build.SCAN_TILE


@pytest.mark.parametrize("size", sorted(chip_smoke.decode_sizes()))
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES)
def test_decode_plain_matches_jax_extract(case, size):
    """``qf_decode`` (its plain version on the CPU) against the JAX
    package's ``extract`` of the same planes, row for row, on tables at the
    decode's tile edges and over three tiles (``chip_smoke.decode_case``,
    which the card's launch check runs through the kernel too)."""
    total = chip_smoke.decode_sizes()[size]
    planes = chip_smoke.decode_case(case, total, torch.device("cpu"))
    fq, fr = qf_decode.qf_decode(*planes)
    assert qf_decode.qf_decode.launches == 0  # CPU tensors: no launch
    assert fq.dtype == fr.dtype == torch.int64 and fq.shape == (total,)
    rem, occ, shf, con = (p.numpy() for p in planes)
    jstate = jqf.QFState(rem=jnp.asarray(rem.view(np.uint32)), occ=jnp.asarray(occ),
                         shf=jnp.asarray(shf), con=jnp.asarray(con), n=jnp.int32(0),
                         overflow=jnp.bool_(False))
    jq, jr, _ = jqf.extract(jqf.QFConfig(q=1, r=8, slack=total - 2), jstate)
    np.testing.assert_array_equal(np.asarray(jq).astype(np.int64), fq.numpy())
    np.testing.assert_array_equal(np.asarray(jr).astype(np.int64), fr.numpy())
    rows = int((occ | shf).sum())
    assert (fq.numpy()[rows:] == jqf.INT32_MAX).all()
    if case == "run_id 0 and past the last bucket":
        assert fq[0] == 0 and (fq[:rows] == total).any()  # both reached
    if case == "empty":
        assert rows == 0


# small specs whose inserts decode on every call: a flat QF, a buffered QF
# that flushes, and a cascade that collapses into three levels
ROUTE_SPECS = {
    "qf": dict(q=9, r=14),
    "buffered_qf": dict(ram_q=6, disk_q=10, p=22),
    "cascade": dict(ram_q=6, p=22, fanout=2, levels=3),
}


@pytest.mark.parametrize("name", sorted(ROUTE_SPECS))
def test_kernel_path_decodes_through_qf_decode(name, monkeypatch):
    """Under ``backend="pallas"`` every decode of an insert, a flush and a
    cascade collapse goes through ``ops.extract`` and ``qf_decode``, none
    through the plain path's ``decode_planes`` (patched to raise here), and
    the state equals the JAX package's after the same batches."""
    from repro import filters as jf
    from repro_torch import filters as tf

    spec = dict(ROUTE_SPECS[name], backend="pallas")
    keys = _keys(50, 336)
    batches = [keys[b : b + 48] for b in range(0, 336, 48)]
    jcfg, jst = jf.make(name, **spec)
    insert = jax.jit(jf.insert, static_argnums=0)
    for b in batches:
        jst = insert(jcfg, jst, jnp.asarray(b))
    extracts, decodes = [], []
    extract, decode = ops.extract, ops.qf_decode

    def refuse(*args, **kw):
        raise AssertionError("the kernel path called decode_planes")

    monkeypatch.setattr(ops, "extract", lambda *a: extracts.append(a[0]) or extract(*a))
    monkeypatch.setattr(ops, "qf_decode", lambda *a: decodes.append(a[0]) or decode(*a))
    monkeypatch.setattr(tqf, "decode_planes", refuse)
    tcfg, tst = tf.make(name, device="cpu", **spec)
    for b in batches:
        tst = tf.insert(tcfg, tst, _t(b))
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    tleaves = tf.to_numpy(tcfg, tst)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert len(decodes) == len(extracts) >= len(batches)
    if name != "qf":  # the flushes and collapses decode a larger table too
        assert len({p.shape[0] for p in decodes}) > 1


def test_decode_tile_matches_the_cuda_source():
    """The wrapper's tile, chunk and bit-word sizes (the scratch it sizes,
    the tests' tile edges) are those of ``csrc/qf_decode.cu``."""
    text = (Path(qf_decode.__file__).parents[1] / "csrc" / "qf_decode.cu").read_text()
    consts = {
        name: int(value)
        for name, value in re.findall(r"constexpr int (DECODE_\w+) = (\d+);", text)
    }
    word = consts["DECODE_LANE_SLOTS"]
    assert word == qf_decode.DECODE_WORD
    assert 32 * word == qf_decode.DECODE_CHUNK
    assert consts["DECODE_THREADS"] * word == qf_decode.DECODE_TILE
    assert "DECODE_CHUNK = 32 * DECODE_LANE_SLOTS;" in text
    assert "DECODE_TILE = DECODE_THREADS * DECODE_LANE_SLOTS;" in text


def test_bloom_count_wrapper_matches_jax_oracle():
    from repro_torch.kernels import bloom_block

    rng = np.random.default_rng(7)
    idx = rng.integers(0, 257, size=600).astype(np.int32)
    idx[::7] = 2**31 - 1  # masked keys count nothing
    got = bloom_block.bloom_count(torch.from_numpy(idx), 257)
    assert bloom_block.bloom_count.launches == 0  # CPU tensors: no launch
    want = jref.bloom_count_ref(jnp.asarray(idx), 257)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["uint8", "int16"])
def test_bloom_probe_wrapper_matches_jax_oracle(dtype):
    from repro_torch.kernels import bloom_block

    rng = np.random.default_rng(8)
    cells = (rng.random(512) < 0.6).astype(np.int64) * rng.integers(1, 3, size=512)
    idx = rng.integers(0, 512, size=(300, 5)).astype(np.int32)
    tcells = torch.from_numpy(cells.astype(np.uint8 if dtype == "uint8" else np.int16))
    got = bloom_block.bloom_probe(tcells, torch.from_numpy(idx))
    assert bloom_block.bloom_probe.launches == 0
    want = jref.bloom_probe_ref(jnp.asarray(cells.astype(np.int32)), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qf_build_span_wrapper_appends_to_the_jax_build():
    """A sorted stream appended in two spans from an empty table gives the
    JAX package's build of the whole stream, with its count and carries."""
    jcfg, tcfg, js, ts, keys = _filled(*WIDE)
    fq, fr = _sorted_stream(tcfg, keys)
    t = tcfg.total_slots
    rem = torch.zeros(t, dtype=torch.int32)
    occ, shf, con = (torch.zeros(t, dtype=torch.bool) for _ in range(3))
    n = torch.zeros((), dtype=torch.int32)
    overflow = torch.zeros((), dtype=torch.bool)
    last_pos = last_fq = torch.full((), -1, dtype=torch.int32)
    cut = keys.shape[0] // 3
    for lo, hi in ((0, cut), (cut, keys.shape[0])):
        k = torch.tensor(hi - lo, dtype=torch.int32)
        n, overflow, last_pos, last_fq = qf_build.qf_build_span(
            fq[lo:hi].contiguous(), fr[lo:hi].contiguous(), k, n, overflow, last_pos,
            last_fq, rem, occ, shf, con,
        )
    assert qf_build.qf_build_span.launches == 0
    assert int(n) == keys.shape[0] and not bool(overflow)
    for f, a, b in zip(("rem", "occ", "shf", "con"), _jplanes(js), (rem, occ, shf, con)):
        np.testing.assert_array_equal(np.asarray(a), b.to(torch.int32).numpy(), err_msg=f)
