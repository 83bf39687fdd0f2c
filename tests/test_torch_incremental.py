"""The port's incremental resize against the JAX package's, bit for bit.

The same numpy keys go through ``repro`` and ``repro_torch`` (state on
the CPU):

* the migration's append, ``kernels.ops.build_chunk``/``build_span``, at
  every cursor of a small stream with ragged chunks (the port's append
  writes into the state's planes, so its side runs on clones; the JAX
  side is pure), and the ``qf_build_span`` wrapper's plain version at
  the edges it must handle;
* ``filters.incremental_resize``: ``begin``/``insert``/``contains``/
  ``finish`` after every step of a drain, the settled table against a
  static build, the one-span ``finish`` drain, the I/O per chunk, the
  buffer-full settle, ``begin_restructure`` of ``buffered_qf`` and of
  the cascade (a frozen target too), and a numpy round trip of a state
  taken mid-migration;
* ``filters.auto_scale`` end to end, its hysteresis, and the cascade's
  level pops.

States compare leaf for leaf (``tf.to_numpy`` against the JAX pytree,
the migration's int64 source stream as int32/uint32), configs field for
field, hits exactly.  The cases mirror ``tests/test_incremental.py``
without the sharded, pipeline and serving-cache ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.core import quotient_filter as jqf
from repro.filters import incremental_resize as jir
from repro.kernels import ops as jops
from repro_torch import filters as tf
from repro_torch.core import quotient_filter as tqf
from repro_torch.filters import incremental_resize as tir
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qf_build


def _keys(seed, n, lo=0, hi=2**31):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _jleaves(jstate):
    return [np.array(x) for x in jax.tree_util.tree_leaves(jstate)]


def _assert_leaves(jleaves, tcfg, tstate, what=""):
    tleaves = tf.to_numpy(tcfg, tstate)
    assert len(jleaves) == len(tleaves), what
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _assert_same(jcfg, jstate, tcfg, tstate, what=""):
    assert tcfg._asdict() == jcfg._asdict(), what
    _assert_leaves(_jleaves(jstate), tcfg, tstate, what)


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _stream(cfg_t, cfg_j, n, seed):
    keys = _keys(seed, n)
    fq, fr = tqf.fingerprints(cfg_t, _tkeys(keys))
    fq, fr = tqf._pad_sort(fq, fr, torch.ones(n, dtype=torch.bool))
    jq, jr = jqf.fingerprints(cfg_j, jnp.asarray(keys))
    jq, jr = jqf._pad_sort(jq, jr, jnp.ones((n,), jnp.bool_))
    return (fq, fr), (jq, jr)


def _assert_qf(jst, tst, what):
    for name, a, b in zip(jst._fields, jst, tst):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int64), b.numpy().astype(np.int64),
            err_msg=f"{what} {name}",
        )


@pytest.mark.parametrize("slack", [128, 4])
def test_build_span_and_chunk_match_jax_at_every_cursor(slack):
    """From every chunk-aligned cursor of a 250-entry stream: one span
    draining the rest, and the ragged chunks that advance the cursor,
    against the JAX package's appends and its ``build_sorted``.  With a
    4-slot slack the last entries fall past the planes and drop."""
    cfg_t = tqf.QFConfig(q=8, r=10, slack=slack)
    cfg_j = jqf.QFConfig(q=8, r=10, slack=slack)
    n = 250
    (fq, fr), (jq, jr) = _stream(cfg_t, cfg_j, n, 50)
    want = jqf.build_sorted(cfg_j, jq, jr, n)
    # sentinel padding past the stream, so that every span and chunk is a
    # slice of one length (the JAX package compiles each length once)
    fq = torch.cat([fq, torch.full((n,), tqf.INT32_MAX)])
    fr = torch.cat([fr, torch.full((n,), tqf.UINT32_MAX)])
    jq = jnp.concatenate([jq, jnp.full((n,), jqf.INT32_MAX, jnp.int32)])
    jr = jnp.concatenate([jr, jnp.full((n,), jqf.UINT32_MAX, jnp.uint32)])
    state = tqf.empty(cfg_t, "cpu")
    jstate = jqf.empty(cfg_j)
    lp, lf = (torch.full((), -1, dtype=torch.int32) for _ in range(2))
    jlp, jlf = jnp.full((), -1, jnp.int32), jnp.full((), -1, jnp.int32)
    cursor = 0
    for size in (1, 37, 2, 0, 64, 46, 64, 36):
        rest = slice(cursor, cursor + n)
        drained, dlp, dlf = tops.build_span(
            cfg_t, _clone(state), fq[rest], fr[rest],
            torch.tensor(n - cursor, dtype=torch.int32), lp, lf,
        )
        jdrained, jdlp, jdlf = jops.build_span(
            cfg_j, jstate, jq[rest], jr[rest], jnp.int32(n - cursor), jlp, jlf
        )
        _assert_qf(jdrained, drained, f"span from {cursor}")
        _assert_qf(want, drained, f"span from {cursor} vs build_sorted")
        assert (int(dlp), int(dlf)) == (int(jdlp), int(jdlf))
        # the chunk is padded past its valid rows, as _advance pads it
        span = slice(cursor, cursor + 64)
        state, lp, lf = tops.build_chunk(cfg_t, state, fq[span], fr[span], size, lp, lf)
        jstate, jlp, jlf = jops.build_chunk(
            cfg_j, jstate, jq[span], jr[span], size, jlp, jlf
        )
        _assert_qf(jstate, state, f"chunk at {cursor}")
        assert (int(lp), int(lf)) == (int(jlp), int(jlf)), cursor
        cursor += size
    assert cursor == n
    _assert_qf(want, state, "chunked build")
    assert bool(state.overflow) == (slack == 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_span_in_random_chunks_matches_jax(seed):
    """A stream with long runs appended in chunks cut at random (empty
    ones among them, and cuts inside runs), each a 48-row slice with its
    first ``k`` rows valid as ``_advance`` pads it, alternating
    ``build_chunk`` and ``build_span``: after every append the planes,
    ``n``, ``overflow`` and the carries equal the JAX package's appends,
    and the planes, ``n`` and ``overflow`` its ``build_sorted`` of the
    prefix.  The slack is short enough that the last runs drop."""
    rng = np.random.default_rng(seed)
    cfg_t = tqf.QFConfig(q=7, r=10, slack=24)
    cfg_j = jqf.QFConfig(q=7, r=10, slack=24)
    n = 170
    fq = np.sort(np.concatenate([rng.integers(0, 128, n - 30), [40] * 18, [127] * 12]))
    fr = rng.integers(0, 1 << 10, n)
    o = np.lexsort((fr, fq))
    fq, fr = fq[o], fr[o]
    width = 48
    tq = torch.from_numpy(np.concatenate([fq, np.full(width, 2**31 - 1)]))
    tr = torch.from_numpy(np.concatenate([fr, np.full(width, 2**32 - 1)]))
    jq, jr = jnp.asarray(tq.numpy().astype(np.int32)), jnp.asarray(
        tr.numpy().astype(np.uint32))
    state, jstate = tqf.empty(cfg_t, "cpu"), jqf.empty(cfg_j)
    lp, lf = (torch.full((), -1, dtype=torch.int32) for _ in range(2))
    jlp, jlf = jnp.full((), -1, jnp.int32), jnp.full((), -1, jnp.int32)
    cursor, step, inside = 0, 0, 0
    while cursor < n:
        size = min(int(rng.integers(0, width + 1)) if step % 3 else 0, n - cursor)
        inside += 0 < cursor < n and fq[cursor] == fq[cursor - 1]
        span = slice(cursor, cursor + width)
        t_append, j_append = ((tops.build_chunk, jops.build_chunk) if step % 2
                              else (tops.build_span, jops.build_span))
        state, lp, lf = t_append(
            cfg_t, state, tq[span], tr[span], torch.tensor(size, dtype=torch.int32),
            lp, lf,
        )
        jstate, jlp, jlf = j_append(cfg_j, jstate, jq[span], jr[span], size, jlp, jlf)
        cursor += size
        step += 1
        _assert_qf(jstate, state, f"append {step} to {cursor}")
        assert (int(lp), int(lf)) == (int(jlp), int(jlf)), step
        _assert_qf(jqf.build_sorted(cfg_j, jq[:n], jr[:n], cursor), state,
                   f"prefix of {cursor} vs build_sorted")
    assert inside > 0 and step > 6
    assert bool(state.overflow)  # the run at the last bucket drops past the slack


def test_span_plain_version_handles_its_edges():
    """The wrapper's plain version (what runs for CPU tensors) scans the
    span from the carried ``last_pos``, writes only the valid items'
    slots, marks a dropped item's bucket, takes the carried ``last_fq``
    for item 0, advances ``n``, ``overflow`` and the carries, and with
    ``k = 0`` writes nothing and keeps the carries."""
    t = 12
    planes = lambda: (torch.zeros(t, dtype=torch.int32),) + tuple(
        torch.zeros(t, dtype=torch.bool) for _ in range(3)
    )
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    # positions 5, 6, 7, 11, 12 (past the last slot), 13 (not valid)
    fq = torch.tensor([5, 5, 6, 11, 11, 11])
    fr = torch.tensor([2**32 - 1, 2, 3, 4, 5, 6])  # the uint32 value of -1
    scalars = (i32(5), i32(7), torch.tensor(False), i32(4), i32(5))
    rem, occ, shf, con = planes()
    n, ovf, lp, lf = qf_build.qf_build_span(fq, fr, *scalars, rem, occ, shf, con)
    assert rem.tolist() == [0] * 5 + [-1, 2, 3, 0, 0, 0, 4]
    assert occ.nonzero().flatten().tolist() == [5, 6, 11]
    assert shf.nonzero().flatten().tolist() == [6, 7]
    assert con.nonzero().flatten().tolist() == [5, 6]  # item 0 continues last_fq
    assert (int(n), bool(ovf), int(lp), int(lf)) == (12, True, 12, 11)
    before = planes()
    after = planes()
    out = qf_build.qf_build_span(fq, fr, i32(0), *scalars[1:], *after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert [x.item() for x in out] == [7, False, 4, 5]
    with pytest.raises(TypeError):  # the int64 streams of core
        qf_build.qf_build_span(fq, fr.to(torch.int32), *scalars, rem, occ, shf, con)
    with pytest.raises(ValueError):
        qf_build.qf_build_span(fq, fr, i32([1]), *scalars[1:], rem, occ, shf, con)


def _filled(f, keys, spec, n, seed):
    cfg, st = f.make("qf", **spec)
    return cfg, f.insert(cfg, st, keys(_keys(seed, n)))


BACKENDS = ["reference", "pallas"]


MIGRATION = dict(q=10, r=14)


def _migration_run(f, ir, keys, cfg, st):
    """Drain a migration by inserts of 16 fresh keys; the observations."""
    old = _keys(0, 768)
    st = f.insert(cfg, st, keys(old))
    mcfg, ms = ir.begin(cfg, st, chunk=96)
    seen = [("begin", _leaves_of(f, mcfg, ms), None)]
    probes = np.concatenate([old[::3], _keys(99, 300, lo=2**31, hi=2**32)])
    steps = 0
    while not bool(ir.migration_done(mcfg, ms)):
        ms = f.insert(mcfg, ms, keys(_keys(1000 + steps, 16, lo=2**31, hi=2**32)))
        hits = np.asarray(f.contains(mcfg, ms, keys(probes)))
        seen.append((f"step {steps}", _leaves_of(f, mcfg, ms), hits))
        steps += 1
    fcfg, fst = ir.finish(mcfg, ms)
    seen.append(("finish", _leaves_of(f, fcfg, fst), None))
    return mcfg, seen, (fcfg, fst)


def _leaves_of(f, cfg, state):
    return _jleaves(state) if f is jf else tf.to_numpy(cfg, state)


_JAX_RUNS = {}


def _jax_once(name, run):
    """The JAX package's side of a test, computed once per process."""
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = run()
    return _JAX_RUNS[name]


@pytest.mark.parametrize("backend", BACKENDS)
def test_migration_matches_jax_at_every_cursor(backend):
    """Old keys, fresh keys and the chunk in transit all hit at every step
    of the drain, and every state equals the JAX package's."""
    jm, jseen, _ = _jax_once(
        "migration",
        lambda: _migration_run(jf, jir, jnp.asarray, *jf.make("qf", **MIGRATION)),
    )
    tcfg, tst = tf.make("qf", device="cpu", **dict(MIGRATION, backend=backend))
    tm, tseen, (fcfg, fst) = _migration_run(_TF, tir, _tkeys, tcfg, tst)
    port = lambda c: c._replace(backend=backend)
    assert tm._asdict() == jm._replace(
        src=port(jm.src), dst=port(jm.dst), buf=port(jm.buf)
    )._asdict()
    assert [w for w, *_ in tseen] == [w for w, *_ in jseen]
    assert len(tseen) >= 9  # amortized over 7+ inserts, not one big pass
    for (what, jl, jh), (_, tl, th) in zip(jseen, tseen):
        assert len(jl) == len(tl), what
        for i, (a, b) in enumerate(zip(jl, tl)):
            assert a.dtype == b.dtype, (what, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")
        if th is not None:
            np.testing.assert_array_equal(th, jh, err_msg=what)
            assert th[:256].all(), what  # every third old key
    assert fcfg.q == tcfg.q + 1
    fresh = np.concatenate(
        [_keys(1000 + i, 16, lo=2**31, hi=2**32) for i in range(len(tseen) - 2)]
    )
    assert tf.contains(fcfg, fst, _tkeys(np.concatenate([_keys(0, 768), fresh]))).all()
    assert not bool(tf.stats(fcfg, fst)["overflow"])


def test_settled_migration_matches_static_filter_exactly():
    """QF fingerprints are split-invariant: the settled table equals the
    JAX package's filter built statically at the final size."""
    cfg, st = _filled(_TF, _tkeys, dict(q=9, r=15, backend="pallas"), 384, 2)
    mcfg, ms = tir.begin(cfg, st, chunk=64)
    fresh = _keys(3, 256, lo=2**31, hi=2**32)
    for i in range(0, 256, 32):
        ms = tf.insert(mcfg, ms, _tkeys(fresh[i : i + 32]))
    fcfg, fst = tir.finish(mcfg, ms)
    jcfg, jst = jf.make("qf", q=fcfg.q, r=fcfg.r, backend="pallas")
    jst = jf.insert(jcfg, jst, jnp.asarray(np.concatenate([_keys(2, 384), fresh])))
    _assert_same(jcfg, jst, fcfg, fst)
    assert int(tf.stats(fcfg, fst)["n"]) == 384 + 256


class _TF:
    make = staticmethod(lambda name, **s: tf.make(name, device="cpu", **s))
    insert, contains = staticmethod(tf.insert), staticmethod(tf.contains)


def test_finish_drains_many_chunks_in_one_span_as_jax():
    """``finish``'s one-span drain over many pending chunks gives the
    planes of chunk-by-chunk advances, and the JAX package's."""
    spec = dict(q=9, r=15)
    cfg, st = _filled(_TF, _tkeys, spec, 384, 60)
    jcfg, jst = _filled(jf, jnp.asarray, spec, 384, 60)
    mcfg, ms = tir.begin(cfg, st, chunk=64)
    jm, jms = jir.begin(jcfg, jst, chunk=64)
    batch = _keys(61, 16, lo=2**31, hi=2**32)
    ms = tf.insert(mcfg, ms, _tkeys(batch))
    jms = jf.insert(jm, jms, jnp.asarray(batch))
    assert not bool(tir.migration_done(mcfg, ms))
    stepwise = type(ms)(*(
        _clone(x) if isinstance(x, tuple) else x.clone() for x in ms
    ))
    while not bool(tir.migration_done(mcfg, stepwise)):
        stepwise = tir._advance(mcfg, stepwise)  # a chunk at a time
    fcfg, fst = tir.finish(mcfg, ms)  # one span drain
    scfg, sst = tir.finish(mcfg, stepwise)
    jfcfg, jfst = jir.finish(jm, jms)
    assert fcfg == scfg
    for name, a, b in zip(fst._fields, fst, sst):
        assert torch.equal(a, b), name
    _assert_same(jfcfg, jfst, fcfg, fst)


def test_io_charged_per_chunk_as_jax():
    spec = dict(q=9, r=15)
    cfg, st = _filled(_TF, _tkeys, spec, 384, 6)
    jcfg, jst = _filled(jf, jnp.asarray, spec, 384, 6)
    mcfg, ms = tir.begin(cfg, st, chunk=128)
    jm, jms = jir.begin(jcfg, jst, chunk=128)
    for i in range(3):
        batch = _keys(7 + i, 16, lo=2**31, hi=2**32)
        ms = tf.insert(mcfg, ms, _tkeys(batch))
        jms = jf.insert(jm, jms, jnp.asarray(batch))
    s, js = tf.stats(mcfg, ms), jf.stats(jm, jms)
    assert set(s) == set(js)
    for k, v in s.items():
        np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(v), k)
    assert int(s["migrate_chunks"]) == 3 and int(s["resizes"]) == 1
    assert float(s["seq_read_bytes"]) == 3 * 128 * mcfg.src.core.bits_per_slot / 8
    assert float(s["seq_write_bytes"]) == 3 * 128 * mcfg.dst.core.bits_per_slot / 8


def test_buffer_full_trips_settle_predicate_as_jax():
    """Fresh inserts outrunning the drain flag ``needs_settle`` before the
    side buffer overflows; the early ``finish`` drains and folds."""
    spec = dict(q=9, r=15)
    cfg, st = _filled(_TF, _tkeys, spec, 384, 9)
    jcfg, jst = _filled(jf, jnp.asarray, spec, 384, 9)
    mcfg, ms = tir.begin(cfg, st, chunk=64, buf_q=7)
    jm, jms = jir.begin(jcfg, jst, chunk=64, buf_q=7)
    assert not bool(tir.needs_settle(mcfg, ms))
    big = _keys(10, mcfg.buf.core.capacity + 64, lo=2**31, hi=2**32)
    ms = tf.insert(mcfg, ms, _tkeys(big))
    jms = jf.insert(jm, jms, jnp.asarray(big))
    assert bool(tir.needs_settle(mcfg, ms)) and bool(jir.needs_settle(jm, jms))
    assert not bool(tir.migration_done(mcfg, ms))
    assert bool(tf.needs_resize(mcfg, ms))  # the façade's predicate is needs_settle
    fcfg, fst = tir.finish(mcfg, ms)
    jfcfg, jfst = jir.finish(jm, jms)
    _assert_same(jfcfg, jfst, fcfg, fst)
    assert tf.contains(fcfg, fst, _tkeys(big)).all()
    assert not bool(tf.stats(fcfg, fst)["overflow"])


AUTO_SCALE_CALLS = 16  # 1024 keys: q = 8 grows twice, through migrations


def _auto_scale_run(f, keys, **kw):
    cfg, st = f.make("qf", q=8, r=16)
    seen = []
    for i in range(AUTO_SCALE_CALLS):
        cfg, st = f.auto_scale(cfg, st, keys(_keys(20 + i, 64)), chunk=256, **kw)
        seen.append((cfg, _jleaves(st) if f is jf else tf.to_numpy(cfg, st)))
    return seen, f.settle(cfg, st)


def test_auto_scale_drives_the_migration_as_jax():
    tseen, (cfg, st) = _auto_scale_run(_TFScale, _tkeys)
    jseen, (jcfg, jst) = _auto_scale_run(jf, jnp.asarray)
    kinds = [type(c).__name__ for c, _ in tseen]
    assert kinds == [type(c).__name__ for c, _ in jseen]
    assert "MigratingQFConfig" in kinds  # grew incrementally on the way
    for i, ((jc, jl), (tc, tl)) in enumerate(zip(jseen, tseen)):
        assert tc._asdict() == jc._asdict(), i
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b, err_msg=f"call {i}")
    _assert_same(jcfg, jst, cfg, st, "settled")
    assert cfg.q > 8
    for i in range(AUTO_SCALE_CALLS):
        assert tf.contains(cfg, st, _tkeys(_keys(20 + i, 64))).all()
    assert not bool(tf.stats(cfg, st)["overflow"])


class _TFScale(_TF):
    auto_scale = staticmethod(tf.auto_scale)
    settle = staticmethod(tf.settle)


def _restructure(family, spec, n, target, chunk):
    """``n`` keys into the port's filter, the same leaves into the JAX
    package's; then in both ``begin_restructure``, three inserts of
    fresh keys and ``finish``, the states compared after every step."""
    tcfg, tst = tf.make(family, device="cpu", **spec)
    ks = _keys(70, n)
    for i in range(0, n, 48):
        tst = tf.insert(tcfg, tst, _tkeys(ks[i : i + 48]))
    jcfg, template = jf.make(family, **spec)  # the same leaves in the JAX package
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(a) for a in tf.to_numpy(tcfg, tst)],
    )
    mcfg, ms = tir.begin_restructure(tcfg, tst, chunk=chunk, **dict(target))
    jm, jms = jir.begin_restructure(jcfg, jst, chunk=chunk, **dict(target))
    assert tir.can_migrate(tcfg) and jir.can_migrate(jcfg)
    _assert_same(jm, jms, mcfg, ms, "begin")
    fresh = [_keys(71 + i, 16, lo=2**31, hi=2**32) for i in range(3)]
    for i, b in enumerate(fresh):
        ms = tf.insert(mcfg, ms, _tkeys(b))
        jms = jf.insert(jm, jms, jnp.asarray(b))
        _assert_same(jm, jms, mcfg, ms, f"insert {i}")
    fcfg, fst = tir.finish(mcfg, ms)
    jfcfg, jfst = jir.finish(jm, jms)
    _assert_same(jfcfg, jfst, fcfg, fst, "finish")
    everything = np.concatenate([ks] + fresh)
    assert tf.contains(fcfg, fst, _tkeys(everything)).all()
    assert int(tf.stats(fcfg, fst)["n"]) == n + 48
    return fcfg, fst, everything


@pytest.mark.parametrize(
    "case",
    ["buffered_qf", "cascade fanout=4", "frozen cascade levels=2"],
)
def test_begin_restructure_matches_jax_and_the_blocking_resize(case):
    family, spec, n, target = {
        "buffered_qf": ("buffered_qf", dict(ram_q=7, disk_q=10, p=26), 600,
                        (("disk_q", 11),)),
        "cascade fanout=4": ("cascade", dict(ram_q=7, p=26, levels=3), 240,
                             (("fanout", 4),)),
        "frozen cascade levels=2": (
            "cascade", dict(ram_q=7, p=26, levels=3, frozen_below=1), 240,
            (("levels", 2),),
        ),
    }[case]
    fcfg, fst, everything = _restructure(family, spec, n, target, 64)
    assert fcfg == tf.make(family, device="cpu", **spec)[0]._replace(**dict(target))
    if family == "cascade":  # the target level the union fits in
        counts = [int(s.n) for s in fst.levels]
        assert sum(counts) == n + 48 and counts.count(0) == len(counts) - 1
    # the same membership as the blocking resize of the same keys
    bcfg, bst = tf.make(family, device="cpu", **spec)
    for i in range(0, n, 48):
        bst = tf.insert(bcfg, bst, _tkeys(everything[i : min(i + 48, n)]))
    bcfg, bst = tf.resize(bcfg, bst, **dict(target))
    bst = tf.insert(bcfg, bst, _tkeys(everything[n:]))
    probes = _tkeys(np.concatenate([everything, _keys(79, 500, lo=2**31, hi=2**32)]))
    if spec.get("frozen_below") is None:  # QF tiers: one fingerprint multiset
        got = tf.contains(fcfg, fst, probes)
        assert torch.equal(got, tf.contains(bcfg, bst, probes))
    assert tf.contains(bcfg, bst, probes)[: everything.shape[0]].all()


def test_numpy_round_trip_mid_migration():
    """A state taken mid-migration crosses to the JAX package and back
    (``to_numpy``/``from_numpy``) and both go on to the same table."""
    spec = dict(q=9, r=15)
    cfg, st = _filled(_TF, _tkeys, spec, 384, 80)
    mcfg, ms = tir.begin(cfg, st, chunk=64)
    for i in range(2):
        ms = tf.insert(mcfg, ms, _tkeys(_keys(81 + i, 16, lo=2**31, hi=2**32)))
    jm = jir.MigratingQFConfig(
        src=jf.make("qf", **spec)[0], dst=jf.make("qf", q=10, r=14)[0],
        buf=jf.make("qf", q=8, r=16)[0], chunk=64,
    )
    assert mcfg._asdict() == jm._asdict()
    treedef = jax.tree_util.tree_structure(jir.blank(jm))
    leaves = tf.to_numpy(mcfg, ms)
    jms = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
    back = tf.from_numpy(mcfg, _jleaves(jms), device="cpu")
    _assert_leaves(leaves, mcfg, back, "round trip")
    batch = _keys(90, 16, lo=2**31, hi=2**32)
    back = tf.insert(mcfg, back, _tkeys(batch))
    jms = jf.insert(jm, jms, jnp.asarray(batch))
    _assert_leaves(_jleaves(jms), mcfg, back, "resumed")
    fcfg, fst = tir.finish(mcfg, back)
    jfcfg, jfst = jir.finish(jm, jms)
    _assert_same(jfcfg, jfst, fcfg, fst, "finished")
    with pytest.raises(ValueError):
        tf.from_numpy(mcfg, leaves[:-1], device="cpu")
    bad = list(leaves)
    bad[0] = bad[0].astype(np.int64)
    with pytest.raises(TypeError):
        tf.from_numpy(mcfg, bad, device="cpu")


def test_migrating_family_is_internal_and_refuses_delete():
    cfg, st = _filled(_TF, _tkeys, dict(q=8, r=16), 192, 12)
    mcfg, ms = tir.begin(cfg, st)
    assert "migrating_qf" not in tf.names()
    assert set(tf.names()) <= set(jf.names())
    assert not tf.supports(mcfg, "delete") and not tf.supports(mcfg, "merge")
    with pytest.raises(tf.UnsupportedOpError):
        tf.delete(mcfg, ms, _tkeys(_keys(13, 8)))
    assert tir.is_migrating(mcfg) and not tir.is_migrating(cfg)
    assert tir.grows_by_migration(cfg) and not tir.grows_by_migration(
        tf.make("cascade", device="cpu", ram_q=6, p=22)[0]
    )
    # grow and resize through the wrapper settle first
    gcfg, gst = tf.grow(mcfg, ms)
    assert gcfg.q == 10 and int(gst.n) == 192
    with pytest.raises(ValueError):
        tir.begin(cfg, st, new_q=8)
    with pytest.raises(ValueError):
        tir.begin(cfg, st, chunk=0)


def test_hysteresis_holds_around_the_boundary_as_jax():
    """After a grow the shrink watermark sits far below the boundary that
    tripped it: deleting and reinserting a band around it never flips
    the size, and every state equals the JAX package's."""
    keys = _keys(35, 192 + 32)

    def run(f, k):
        cfg, st = f.make("qf", q=8, r=16)
        cfg, st = f.auto_scale(cfg, st, k(keys), incremental=False)
        seen = [(cfg.q, st)]
        for _ in range(4):
            st = f.delete(cfg, st, k(keys[:16]))
            cfg, st = f.auto_scale(cfg, st, k(keys[:16]), incremental=False)
            seen.append((cfg.q, st))
        return cfg, seen

    tcfg, tseen = run(_TFDelete, _tkeys)
    jcfg, jseen = run(jf, jnp.asarray)
    assert [q for q, _ in tseen] == [q for q, _ in jseen] == [9] * 5
    for (_, js), (_, ts) in zip(jseen, tseen):
        _assert_leaves(_jleaves(js), tcfg, ts)


class _TFDelete(_TFScale):
    delete = staticmethod(tf.delete)


def test_cascade_auto_scale_grows_and_pops_empty_levels():
    """``auto_scale`` deepens a cascade by free ``grow`` steps (it has no
    incremental growth); after deletes it pops the empty deepest levels."""
    cfg, st = tf.make("cascade", device="cpu", ram_q=7, p=30, fanout=4, levels=1)
    keys = _keys(33, 3000)
    for i in range(0, 3000, 64):
        cfg, st = tf.auto_scale(cfg, st, _tkeys(keys[i : i + 64]))
    assert cfg.levels > 1 and not tir.is_migrating(cfg)
    st = tf.delete(cfg, st, _tkeys(keys[:2950]))
    popped = 0
    while bool(tf.needs_shrink(cfg, st)):
        cfg, st = tf.shrink(cfg, st)
        popped += 1
    assert popped >= 1
    assert tf.contains(cfg, st, _tkeys(keys[2950:])).all()
    assert not bool(tf.needs_resize(cfg, st))


def test_cascade_restructure_whose_buffer_outgrows_the_target_level():
    """Fresh keys that arrive mid-migration can push the count past the
    level the migrated table was built for.  The JAX package then places
    that table, as it is, in the next level, whose geometry is another
    (a fault of the reference, ROADMAP.md Queue 3); the port re-streams it
    into that level, so the planes fit their level and every key hits.
    The port's level equals the JAX package's own re-stream of its
    misplaced table, and the rest of the state equals the JAX package's."""
    spec = dict(ram_q=7, p=26, levels=3)
    tcfg, tst = tf.make("cascade", device="cpu", **spec)
    keys = _keys(90, 240)
    for i in range(0, 240, 48):
        tst = tf.insert(tcfg, tst, _tkeys(keys[i : i + 48]))
    jcfg, template = jf.make("cascade", **spec)
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(a) for a in tf.to_numpy(tcfg, tst)],
    )
    mcfg, ms = tir.begin_restructure(tcfg, tst, chunk=64, fanout=4)
    jm, jms = jir.begin_restructure(jcfg, jst, chunk=64, fanout=4)
    assert mcfg.dst.q == 9  # level 0 of fanout 4 holds the 240 keys
    fresh = [_keys(91 + i, 16, lo=2**31, hi=2**32) for i in range(10)]
    for b in fresh:
        ms = tf.insert(mcfg, ms, _tkeys(b))
        jms = jf.insert(jm, jms, jnp.asarray(b))
    fcfg, fst = tir.finish(mcfg, ms)
    jfcfg, jfst = jir.finish(jm, jms)
    assert fcfg._asdict() == jfcfg._asdict()
    # 400 keys: past level 0's capacity of 384, so level 1 is the target
    assert [int(s.n) for s in fst.levels] == [0, 400, 0]
    assert fst.levels[1].rem.shape[0] == fcfg.level_cfg(1).total_slots
    assert jfst.levels[1].rem.shape[0] == jfcfg.level_cfg(0).total_slots
    want = jqf.multi_merge(
        jfcfg.level_cfg(1), [(jfcfg.level_cfg(0), jfst.levels[1])]
    )
    _assert_qf(want, fst.levels[1], "re-streamed level")
    jleaves, tleaves = _jleaves(jfst), tf.to_numpy(fcfg, fst)
    level1 = slice(6 + 6, 6 + 12)  # q0's six leaves, level 0's, then level 1's
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        if level1.start <= i < level1.stop:
            continue
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    everything = np.concatenate([keys] + fresh)
    assert tf.contains(fcfg, fst, _tkeys(everything)).all()
