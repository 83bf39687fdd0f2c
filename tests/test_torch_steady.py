"""The port's steady-state QF (``steady_qf``) against the JAX package's, bit for bit.

The same numpy keys go through ``repro`` and ``repro_torch`` (state on
the CPU):

* every case of ``tests/test_steady_state.py``, with the states compared
  leaf for leaf after each op (planes, ``n``, ``overflow``, the three
  settle streams, cursors, carries, ``clean`` and the ``IOCounters``,
  float32 counters without tolerance);
* the ``steady_qf`` cases of ``tests/test_resize.py`` (q = 9) and the
  ``steady_qf``/``steady_qf_pallas`` conformance cases of
  ``tests/test_filters_api.py`` (q = 12);
* ``begin_restructure``/``finish`` (the re-wrap) of a steady table, and
  ``auto_scale`` across a steady growth;
* ``filters.to_numpy``/``from_numpy`` round trips of an idle state, one
  taken mid-settle and one mid-migration.

The port runs each case under both backend spellings (``"pallas"`` on
the kernels' plain versions here).  The JAX side runs each case once,
under ``"reference"``: its ``"pallas"`` spelling gives the same states
(``tests/test_steady_state.py`` and ``tests/test_kernels.py``), and its
settle appends run the kernel path's ``build_chunk``/``build_span``
under either.  The port's insert writes the state's planes in place, so
every observation is copied out (``to_numpy``) when it is taken.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.data.pipeline import DedupPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.filters import incremental_resize as jir
from repro.filters import steady as js
from repro_torch import filters as tf
from repro_torch.data.pipeline import DedupPipeline, PipelineConfig
from repro_torch.filters import incremental_resize as tir
from repro_torch.filters import steady as ts
from repro_torch.filters.qf_filter import QFilterConfig

BACKENDS = ["reference", "pallas"]
JAX_BACKEND = "reference"


def _keys(seed, n, lo=0, hi=2**32):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy())


def _plain(cfg, backend):
    """A config as nested tuples, every ``backend`` field set to ``backend``."""
    if not hasattr(cfg, "_fields"):
        return cfg
    d = {k: _plain(v, backend) for k, v in cfg._asdict().items()}
    if "backend" in d:
        d["backend"] = backend
    return tuple(d.items())


def _jleaves(state):
    return [np.array(x) for x in jax.tree_util.tree_leaves(state)]


def _assert_leaves(jleaves, tleaves, what=""):
    assert len(jleaves) == len(tleaves), what
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _assert_same(jcfg, jstate, tcfg, tstate, what=""):
    """Equal configs (but for the backend spelling) and equal leaves."""
    assert _plain(jcfg, None) == _plain(tcfg, None), what
    _assert_leaves(_jleaves(jstate), tf.to_numpy(tcfg, tstate), what)


def _to_jax(tcfg, tstate):
    """The JAX package's ``(cfg, state)`` holding the port's steady state."""
    jcfg, template = jf.make("steady_qf", **dict(tcfg._asdict(), backend=JAX_BACKEND))
    treedef = jax.tree_util.tree_structure(template)
    leaves = [jnp.asarray(a) for a in tf.to_numpy(tcfg, tstate)]
    return jcfg, jax.tree_util.tree_unflatten(treedef, leaves)


class _Jax:
    """``repro.filters`` and the steady internals the cases drive."""

    keys = staticmethod(jnp.asarray)
    cat = staticmethod(jnp.concatenate)
    insert, contains, delete, stats = jf.insert, jf.contains, jf.delete, jf.stats
    merge, grow, auto_grow, auto_scale = jf.merge, jf.grow, jf.auto_grow, jf.auto_scale
    needs_resize = jf.needs_resize
    settle_all = staticmethod(js.settle_all)
    # jitted once per config: run eagerly, every tick dispatches op by op
    open_settle = staticmethod(jax.jit(js._open_settle, static_argnums=0))
    drain = staticmethod(jax.jit(js._drain, static_argnums=(0, 2)))
    leaves = staticmethod(lambda cfg, st: _jleaves(st))

    @staticmethod
    def make(**spec):
        return jf.make("steady_qf", **dict(spec, backend=JAX_BACKEND))


def _port(backend):
    class _Port:
        keys = staticmethod(_tkeys)
        cat = staticmethod(torch.cat)
        insert, contains, delete, stats = tf.insert, tf.contains, tf.delete, tf.stats
        merge, grow, auto_grow, auto_scale = tf.merge, tf.grow, tf.auto_grow, tf.auto_scale
        needs_resize = tf.needs_resize
        settle_all = staticmethod(ts.settle_all)
        open_settle = staticmethod(lambda cfg, st: ts._open_settle(cfg, st, bool(st.clean)))
        drain = staticmethod(ts._drain)
        leaves = staticmethod(tf.to_numpy)

        @staticmethod
        def make(**spec):
            return tf.make("steady_qf", device="cpu", **dict(spec, backend=backend))

    return _Port


# -- the cases of tests/test_steady_state.py --------------------------------
# Each takes a package adapter ``f`` and ``obs(label, cfg, state)``, which
# records the state as numpy leaves when it is called.


def _settling(st):
    return bool((st.cursor < st.src_n) | (st.bcursor < st.bsrc_n))


def no_false_negatives_at_every_cursor_position(f, obs):
    """Drive the drain one tick at a time; at every cursor the settled
    prefix, both stream suffixes and fresh buffered keys answer."""
    cfg, st = f.make(q=10, r=16, buf_q=7, chunk=32)
    old = f.keys(_keys(0, 600))
    st = f.insert(cfg, st, old)
    obs("forced insert", cfg, st)
    st = f.settle_all(cfg, st)
    obs("settle_all", cfg, st)
    buffered = f.keys(_keys(1, 64, lo=2**31))
    st = f.insert(cfg, st, buffered)
    obs("insert", cfg, st)
    st = f.open_settle(cfg, st)
    obs("open", cfg, st)
    steps = 0
    while _settling(st):
        st = f.drain(cfg, st, 1)
        obs(f"tick {steps}", cfg, st)
        assert bool(f.contains(cfg, st, old).all()), f"tick {steps}"
        assert bool(f.contains(cfg, st, buffered).all()), f"tick {steps}"
        steps += 1
    assert steps >= 5  # actually chunked, not one big pass
    s = f.stats(cfg, st)
    assert int(s["n"]) == 600 + 64
    assert not bool(s["overflow"])


def inserts_during_drain_stay_exact(f, obs):
    """Writer races the drain: keys inserted while a settle is open land
    in the fresh buffer and are visible immediately."""
    cfg, st = f.make(q=10, r=16, buf_q=7, chunk=32, settle_load=0.3)
    # every batch's probe is all 15 batches, of which the inserted prefix
    # must hit: one probe shape, so the JAX side compiles it once
    allk = f.keys(np.concatenate([_keys(100 + i, 48) for i in range(15)]))
    for i in range(15):
        st = f.insert(cfg, st, allk[48 * i : 48 * (i + 1)])
        obs(f"batch {i}", cfg, st)
        assert bool(f.contains(cfg, st, allk)[: 48 * (i + 1)].all()), f"batch {i}"
    s = f.stats(cfg, st)
    assert int(s["n"]) == 15 * 48
    assert int(s["settles"]) >= 2  # the watermark actually tripped
    assert not bool(s["overflow"])


def oversized_batch_forces_settle_and_stays_exact(f, obs):
    cfg, st = f.make(q=12, r=18, buf_q=8, chunk=64)
    cap = cfg.buf.capacity
    big = f.keys(_keys(2, cap + 200))  # cannot fit the buffer: forced path
    st = f.insert(cfg, st, big)
    obs("forced", cfg, st)
    assert bool(f.contains(cfg, st, big).all())
    s = f.stats(cfg, st)
    assert int(s["n"]) == cap + 200
    assert int(s["buffered"]) == 0  # landed in the table, not the buffer
    assert not bool(s["overflow"])
    # the normal watermark path resumes after a forced insert
    more = [f.keys(_keys(3 + i, 64)) for i in range(6)]
    for i, b in enumerate(more):
        st = f.insert(cfg, st, b)
        obs(f"insert {i}", cfg, st)
    assert bool(f.contains(cfg, st, f.cat([big] + more)).all())
    assert int(f.stats(cfg, st)["n"]) == cap + 200 + 6 * 64


def forced_mid_settle_folds_pending_streams(f, obs):
    """A forced insert arriving mid-settle folds both pending stream
    suffixes before the direct insert."""
    cfg, st = f.make(q=10, r=16, buf_q=7, chunk=16)
    old = f.keys(_keys(4, 500))
    st = f.insert(cfg, st, old)
    st = f.settle_all(cfg, st)
    obs("settled", cfg, st)
    mid = f.keys(_keys(5, 64, lo=2**31))
    st = f.insert(cfg, st, mid)
    st = f.open_settle(cfg, st)
    st = f.drain(cfg, st, 1)  # leave the settle half-done
    obs("half drained", cfg, st)
    assert _settling(st)
    big = f.keys(_keys(6, cfg.buf.capacity + 50))
    st = f.insert(cfg, st, big)
    obs("forced", cfg, st)
    for part in (old, mid, big):
        assert bool(f.contains(cfg, st, part).all())
    assert int(f.stats(cfg, st)["n"]) == 500 + 64 + cfg.buf.capacity + 50


def settle_of_empty_buffer_is_a_counted_noop(f, obs):
    """settle_all on an idle filter changes nothing and does not bump the
    settles counter."""
    cfg, st = f.make(q=10, r=16, buf_q=7)
    keys = f.keys(_keys(7, 80))  # fits the buffer: the fold below is real
    st = f.insert(cfg, st, keys)
    st = f.settle_all(cfg, st)
    obs("settled", cfg, st)
    before = f.stats(cfg, st)
    assert int(before["settles"]) >= 1
    st = f.settle_all(cfg, st)  # nothing buffered, nothing pending
    obs("settled again", cfg, st)
    after = f.stats(cfg, st)
    assert int(after["n"]) == int(before["n"]) == 80
    assert int(after["settles"]) == int(before["settles"])
    assert bool(f.contains(cfg, st, keys).all())


def duplicates_spanning_buffer_and_table_keep_multiset_counts(f, obs):
    """One copy in the table and one buffered: the fold keeps both, so one
    delete leaves a hit and a second removes it."""
    cfg, st = f.make(q=10, r=16, buf_q=7)
    dup = f.keys(_keys(8, 50))
    st = f.insert(cfg, st, dup)
    st = f.settle_all(cfg, st)  # first copies now in the table
    st = f.insert(cfg, st, dup)  # second copies in the buffer
    obs("buffered copies", cfg, st)
    st = f.settle_all(cfg, st)  # fold: the table stream meets the dups
    obs("folded", cfg, st)
    assert int(f.stats(cfg, st)["n"]) == 100
    st = f.delete(cfg, st, dup)
    obs("first delete", cfg, st)
    assert bool(f.contains(cfg, st, dup).all()), "second copies lost"
    assert int(f.stats(cfg, st)["n"]) == 50
    st = f.delete(cfg, st, dup)
    obs("second delete", cfg, st)
    assert int(f.stats(cfg, st)["n"]) == 0


def merge_of_two_steady_filters_is_exact(f, obs):
    cfg, sa = f.make(q=10, r=16, buf_q=7)
    _, sb = f.make(q=10, r=16, buf_q=7)
    ka, kb = f.keys(_keys(9, 300)), f.keys(_keys(10, 300, lo=2**31))
    sa = f.insert(cfg, sa, ka)
    sb = f.insert(cfg, sb, kb)  # sb still partly buffered
    obs("a", cfg, sa)
    obs("b", cfg, sb)
    sm = f.merge(cfg, sa, sb)
    obs("merged", cfg, sm)
    assert bool(f.contains(cfg, sm, f.cat([ka, kb])).all())
    assert int(f.stats(cfg, sm)["n"]) == 600


STEADY_CASES = {
    fn.__name__: fn
    for fn in (
        no_false_negatives_at_every_cursor_position,
        inserts_during_drain_stay_exact,
        oversized_batch_forces_settle_and_stays_exact,
        forced_mid_settle_folds_pending_streams,
        settle_of_empty_buffer_is_a_counted_noop,
        duplicates_spanning_buffer_and_table_keep_multiset_counts,
        merge_of_two_steady_filters_is_exact,
    )
}


def _observe(case, f):
    seen = []

    def obs(label, cfg, st):
        seen.append((label, _plain(cfg, None), f.leaves(cfg, st)))

    case(f, obs)
    return seen


@functools.lru_cache(maxsize=None)
def _jax_observed(name):
    return _observe(STEADY_CASES[name], _Jax)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(STEADY_CASES))
def test_steady_case_matches_jax_after_every_op(name, backend):
    jseen = _jax_observed(name)
    tseen = _observe(STEADY_CASES[name], _port(backend))
    assert [s[0] for s in tseen] == [s[0] for s in jseen]
    for (label, jcfg, jl), (_, tcfg, tl) in zip(jseen, tseen):
        assert tcfg == jcfg, label
        _assert_leaves(jl, tl, label)


def test_pipeline_snapshot_mid_settle_roundtrips_and_resumes():
    """A dedup pipeline's snapshot taken mid-drain restores bit for bit
    into a fresh pipeline and keeps deduplicating; every step of the JAX
    pipeline's run gives the same filter leaves."""
    spec = dict(
        dedup_family="steady_qf",
        dedup_ram_q=10,
        dedup_p=26,
        dedup_chunk=32,
        seq_len=64,
        batch_size=2,
        seed=3,
    )
    jpipe = JaxPipeline(JaxPipelineConfig(**spec))
    pipe = DedupPipeline(PipelineConfig(**spec), device="cpu")
    ids0, _ = pipe.corpus.batch(500)
    jids0, _ = jpipe.corpus.batch(500)
    np.testing.assert_array_equal(ids0, jids0)
    np.testing.assert_array_equal(pipe._dedup(ids0), jpipe._dedup(jids0))
    extra = _keys(11, 64, lo=2**31)
    for p, f in ((jpipe, _Jax), (pipe, _port("reference"))):
        fcfg = p.filter_cfg
        p.filter_state = f.settle_all(fcfg, p.filter_state)
        p.filter_state = f.insert(fcfg, p.filter_state, f.keys(extra))
        p.filter_state = f.open_settle(fcfg, p.filter_state)
        p.filter_state = f.drain(fcfg, p.filter_state, 1)
    assert _settling(pipe.filter_state)
    snap, jsnap = pipe.snapshot(), jpipe.snapshot()
    _assert_leaves(jsnap["filter_leaves"], snap["filter_leaves"], "snapshot")

    fresh = DedupPipeline(PipelineConfig(**spec), device="cpu")
    fresh.restore(snap)
    _assert_leaves(snap["filter_leaves"], tf.to_numpy(fresh.filter_cfg, fresh.filter_state))
    kept = np.unique(ids0)
    assert bool(tf.contains(fresh.filter_cfg, fresh.filter_state, _tkeys(kept)).all())
    assert bool(tf.contains(fresh.filter_cfg, fresh.filter_state, _tkeys(extra)).all())
    # a replay of the same documents dedups them all away
    assert not fresh._dedup(ids0).any()
    fresh.filter_state = ts.settle_all(fresh.filter_cfg, fresh.filter_state)
    s = tf.stats(fresh.filter_cfg, fresh.filter_state)
    assert int(s["n"]) == len(kept) + extra.shape[0]
    assert not bool(s["overflow"])
    jfresh = JaxPipeline(JaxPipelineConfig(**spec))
    jfresh.restore(jsnap)
    assert not jfresh._dedup(ids0).any()
    jfresh.filter_state = js.settle_all(jfresh.filter_cfg, jfresh.filter_state)
    _assert_same(jfresh.filter_cfg, jfresh.filter_state, fresh.filter_cfg, fresh.filter_state)


# -- the steady_qf conformance cases of tests/test_filters_api.py -----------

CONFORMANCE = {
    "steady_qf": dict(q=12, r=18),
    "steady_qf_pallas": dict(q=12, r=18, backend="pallas"),
}
N = 1024
CHUNK = 128


def _fill(f, cfg, st, keys):
    for i in range(0, keys.shape[0], CHUNK):
        st = f.insert(cfg, st, keys[i : i + CHUNK])
    return st


@functools.lru_cache(maxsize=None)
def _jax_filled(seed, lo=0, hi=2**31):
    cfg, st = _Jax.make(q=12, r=18)
    st = _fill(_Jax, cfg, st, jnp.asarray(_keys(seed, N, lo, hi)))
    return cfg, _jleaves(st)


def _port_filled(case, seed, lo=0, hi=2**31):
    cfg, st = tf.make("steady_qf", device="cpu", **CONFORMANCE[case])
    st = _fill(tf, cfg, st, _tkeys(_keys(seed, N, lo, hi)))
    _assert_leaves(_jax_filled(seed, lo, hi)[1], tf.to_numpy(cfg, st), f"fill {seed}")
    return cfg, st


@pytest.fixture(params=sorted(CONFORMANCE), name="case")
def _case(request):
    return request.param


class TestConformance:
    def test_no_false_negatives(self, case):
        cfg, st = _port_filled(case, 1)
        assert bool(tf.contains(cfg, st, _tkeys(_keys(1, N, 0, 2**31))).all())

    def test_fp_rate_bounded(self, case):
        cfg, st = _port_filled(case, 2)
        absent = _tkeys(_keys(3, 8192, lo=2**31, hi=2**32))
        assert float(tf.contains(cfg, st, absent).float().mean()) < 0.01

    def test_empty_contains_nothing(self, case):
        cfg, st = tf.make("steady_qf", device="cpu", **CONFORMANCE[case])
        assert not bool(tf.contains(cfg, st, _tkeys(_keys(4, 256))).any())

    def test_insert_valid_count_ignores_padding(self, case):
        cfg, st = tf.make("steady_qf", device="cpu", **CONFORMANCE[case])
        keys = _keys(5, CHUNK, 0, 2**31)
        st = tf.insert(cfg, st, _tkeys(keys), k=CHUNK // 2)
        assert bool(tf.contains(cfg, st, _tkeys(keys[: CHUNK // 2])).all())
        assert int(tf.stats(cfg, st)["n"]) == CHUNK // 2
        jcfg, jst = _Jax.make(q=12, r=18)
        jst = jf.insert(jcfg, jst, jnp.asarray(keys), k=CHUNK // 2)
        _assert_leaves(_jleaves(jst), tf.to_numpy(cfg, st), "padded insert")

    def test_delete_removes_one_copy(self, case):
        cfg, st = _port_filled(case, 6)
        keys = _keys(6, N, 0, 2**31)
        jcfg, jst = _to_jax(cfg, st)
        st = tf.delete(cfg, st, _tkeys(keys[: N // 2]))
        jst = jf.delete(jcfg, jst, jnp.asarray(keys[: N // 2]))
        _assert_leaves(_jleaves(jst), tf.to_numpy(cfg, st), "delete")
        assert bool(tf.contains(cfg, st, _tkeys(keys[N // 2 :])).all())
        assert int(tf.stats(cfg, st)["n"]) == N // 2

    def test_merge_is_union(self, case):
        cfg, sa = _port_filled(case, 7)
        _, sb = _port_filled(case, 8, lo=2**30, hi=2**31)
        jcfg, jsa = _to_jax(cfg, sa)
        jmerged = jf.merge(jcfg, jsa, _to_jax(cfg, sb)[1])
        merged = tf.merge(cfg, sa, sb)
        _assert_leaves(_jleaves(jmerged), tf.to_numpy(cfg, merged), "merge")
        assert bool(tf.contains(cfg, merged, _tkeys(_keys(7, N, 0, 2**31))).all())
        assert bool(tf.contains(cfg, merged, _tkeys(_keys(8, N, 2**30, 2**31))).all())
        assert not bool(tf.stats(cfg, merged)["overflow"])

    def test_stats_are_device_values(self, case):
        cfg, st = tf.make("steady_qf", device="cpu", **CONFORMANCE[case])
        st = tf.insert(cfg, st, _tkeys(_keys(9, CHUNK, 0, 2**31)))
        s = tf.stats(cfg, st)
        assert isinstance(s, dict) and s
        for v in s.values():
            assert isinstance(v, (torch.Tensor, int, float))
        js_ = jf.stats(*_to_jax(cfg, st))
        assert set(s) == set(js_)
        for k, v in s.items():
            np.testing.assert_array_equal(np.asarray(js_[k]), np.asarray(v), k)


def test_registry_and_geometry_checks_match_jax():
    assert "steady_qf" in tf.names()
    assert tf.by_name("steady_qf").paper_section.startswith("§")
    for op in ("delete", "merge", "grow", "resize", "shrink", "needs_shrink"):
        assert tf.supports("steady_qf", op), op
    for bad in (
        dict(q=10, r=16, buf_q=10),  # buf_q must lie below q
        dict(q=10, r=23, buf_q=1, backend="pallas"),  # buffer remainder 32
        dict(q=10, r=16, chunk=0),
        dict(q=10, r=16, settle_load=0.0),
        dict(q=10, r=16, backend="triton"),
    ):
        with pytest.raises(ValueError):
            jf.make("steady_qf", **bad)
        with pytest.raises(ValueError):
            tf.make("steady_qf", device="cpu", **bad)
    cfg, _ = tf.make("steady_qf", device="cpu", q=10, r=16)
    assert cfg == ts.SteadyQFConfig(q=10, r=16, buf_q=8)
    assert cfg._asdict() == jf.make("steady_qf", q=10, r=16)[0]._asdict()


# -- the steady_qf cases of tests/test_resize.py (q = 9, chunk 64) ----------

GROW_SPEC = dict(q=9, r=16)
GROW_CHUNK = 64


@pytest.mark.parametrize("backend", BACKENDS)
def test_needs_resize_is_a_device_scalar(backend):
    cfg, st = _port(backend).make(**GROW_SPEC)
    flag = tf.needs_resize(cfg, st)
    assert flag.shape == () and flag.dtype == torch.bool and not bool(flag)


@pytest.mark.parametrize("backend", BACKENDS)
def test_grow_doubles_and_clears_predicate_matches_jax(backend):
    f = _port(backend)
    cfg, st = f.make(**GROW_SPEC)
    keys = _keys(1, cfg.table.capacity, 0, 2**31)
    for i in range(0, keys.shape[0], GROW_CHUNK):
        st = tf.insert(cfg, st, _tkeys(keys[i : i + GROW_CHUNK]))
    jcfg, jst = _to_jax(cfg, st)
    assert bool(tf.needs_resize(cfg, st)) and bool(jf.needs_resize(jcfg, jst))
    new_cfg, new_st = tf.grow(cfg, st)
    jnew_cfg, jnew_st = jf.grow(jcfg, jst)
    _assert_same(jnew_cfg, jnew_st, new_cfg, new_st, "grow")
    assert new_cfg != cfg
    assert not bool(tf.needs_resize(new_cfg, new_st))
    assert bool(tf.contains(new_cfg, new_st, _tkeys(keys)).all())


@pytest.mark.parametrize("backend", BACKENDS)
def test_ingest_8x_initial_capacity_matches_jax(backend):
    """``auto_grow`` over 8x the initial capacity; every call that grows is
    held against the JAX package's ``grow`` steps of the same leaves (the
    inserts are held against the JAX package's by the cases above)."""
    cfg, st = _port(backend).make(**GROW_SPEC)
    n = 8 * cfg.table.capacity
    keys = _keys(2, n, 0, 2**31)
    grows = 0
    for i in range(0, n, GROW_CHUNK):
        batch = _tkeys(keys[i : i + GROW_CHUNK])
        before = cfg, tf.to_numpy(cfg, st)
        cfg, st = tf.auto_grow(cfg, st, batch)
        if cfg != before[0]:
            pcfg = before[0]
            inserted = tf.insert(pcfg, tf.from_numpy(pcfg, before[1], "cpu"), batch)
            jcfg, jst = _to_jax(pcfg, inserted)
            while bool(jf.needs_resize(jcfg, jst)):
                jcfg, jst = jf.grow(jcfg, jst)
            _assert_same(jcfg, jst, cfg, st, f"grew at {i}")
            grows += 1
    assert grows >= 2
    s = tf.stats(cfg, st)
    assert int(s["n"]) == keys.shape[0]
    assert not bool(s["overflow"])
    assert bool(tf.contains(cfg, st, _tkeys(keys)).all())


@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_and_shrink_match_jax(backend):
    """``resize`` to q + 2 and ``shrink`` back to the low watermark, each on
    the JAX package's copy of the same leaves beside it."""
    f = _port(backend)
    cfg, st = f.make(q=10, r=16)
    keys = _keys(3, 120, 0, 2**31)
    st = tf.insert(cfg, st, _tkeys(keys))
    jcfg, jst = _to_jax(cfg, st)
    cfg, st = tf.resize(cfg, st, new_q=12)
    jcfg, jst = jf.resize(jcfg, jst, new_q=12)
    _assert_same(jcfg, jst, cfg, st, "resize")
    steps = 0
    while bool(tf.needs_shrink(cfg, st)):
        jcfg, jst = _to_jax(cfg, st)
        assert bool(jf.needs_shrink(jcfg, jst))
        cfg, st = tf.shrink(cfg, st)
        jcfg, jst = jf.shrink(jcfg, jst)
        _assert_same(jcfg, jst, cfg, st, f"shrink {steps}")
        steps += 1
    assert steps >= 1 and cfg.q < 12
    assert not bool(jf.needs_shrink(*_to_jax(cfg, st)))
    assert bool(tf.contains(cfg, st, _tkeys(keys)).all())


# -- restructure, auto_scale and the state round trips ----------------------


def _mid_settle(f, seed=20):
    """A q = 10 steady filter with a settle half drained."""
    cfg, st = f.make(q=10, r=16, buf_q=7, chunk=32)
    st = f.insert(cfg, st, f.keys(_keys(seed, 600)))
    st = f.insert(cfg, st, f.keys(_keys(seed + 1, 64, lo=2**31)))
    st = f.open_settle(cfg, st)
    return cfg, f.drain(cfg, st, 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_begin_restructure_and_rewrap_of_a_steady_table_match_jax(backend):
    """Mid-settle, ``begin_restructure`` settles and migrates the table to
    ``new_q``; fresh batches go through the migration; ``finish`` re-wraps
    the drained table as an idle steady state.  Each step equals the
    JAX package's on the same leaves."""
    f = _port(backend)
    cfg, st = _mid_settle(f)
    assert _settling(st)
    jcfg, jst = _to_jax(cfg, st)
    mcfg, ms = tir.begin_restructure(cfg, st, chunk=96, new_q=12)
    jmcfg, jms = jir.begin_restructure(jcfg, jst, chunk=96, new_q=12)
    _assert_same(jmcfg, jms, mcfg, ms, "begin")
    assert mcfg.wrap == ts.SteadyQFConfig(q=12, r=14, buf_q=9, chunk=32,
                                          backend=backend)
    batches = [_keys(30 + i, 16, lo=2**31) for i in range(4)]
    for i, b in enumerate(batches):
        ms = tf.insert(mcfg, ms, _tkeys(b))
        jms = jf.insert(jmcfg, jms, jnp.asarray(b))
        _assert_same(jmcfg, jms, mcfg, ms, f"migrating insert {i}")
    cfg2, st2 = tir.finish(mcfg, ms)
    jcfg2, jst2 = jir.finish(jmcfg, jms)
    _assert_same(jcfg2, jst2, cfg2, st2, "finish")
    assert isinstance(cfg2, ts.SteadyQFConfig) and not _settling(st2)
    everything = np.concatenate([_keys(20, 600), _keys(21, 64, lo=2**31)] + batches)
    assert bool(tf.contains(cfg2, st2, _tkeys(everything)).all())
    assert int(tf.stats(cfg2, st2)["n"]) == everything.shape[0]
    assert tir.grows_by_migration(cfg) and tir.can_migrate(cfg)


def _auto_scale_run(f):
    cfg, st = f.make(q=9, r=16, chunk=32)
    keys = _keys(40, 3 * cfg.table.capacity // 2, 0, 2**31)
    seen = []
    for i in range(0, keys.shape[0], 32):
        cfg, st = f.auto_scale(cfg, st, f.keys(keys[i : i + 32]), chunk=96)
        label = f"call {i // 32} ({type(cfg).__name__})"
        seen.append((label, _plain(cfg, None), f.leaves(cfg, st)))
    return seen, cfg, st, keys


@functools.lru_cache(maxsize=None)
def _jax_auto_scale():
    return _auto_scale_run(_Jax)[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_auto_scale_across_a_steady_growth_matches_jax(backend):
    seen, cfg, st, keys = _auto_scale_run(_port(backend))
    jseen = _jax_auto_scale()
    assert [s[0] for s in seen] == [s[0] for s in jseen]
    migrating = ["MigratingQFConfig" in label for label, _, _ in seen]
    assert any(migrating) and not migrating[-1]  # migrated, then settled
    for (label, jc, jl), (_, tc, tl) in zip(jseen, seen):
        assert tc == jc, label
        _assert_leaves(jl, tl, label)
    assert isinstance(cfg, ts.SteadyQFConfig) and cfg.q > 9
    assert bool(tf.contains(cfg, st, _tkeys(keys)).all())
    assert not bool(tf.stats(cfg, st)["overflow"])


def _round_trip(jcfg, jst, tcfg, batch):
    """JAX leaves -> port state -> the same leaves; one insert each side
    after, then the port's state back into the JAX package."""
    leaves = _jleaves(jst)
    ts_ = tf.from_numpy(tcfg, leaves, device="cpu")
    _assert_leaves(leaves, tf.to_numpy(tcfg, ts_), "from_numpy")
    ts_ = tf.insert(tcfg, ts_, _tkeys(batch))
    jst = jf.insert(jcfg, jst, jnp.asarray(batch))
    _assert_leaves(_jleaves(jst), tf.to_numpy(tcfg, ts_), "insert after")
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jst),
        [jnp.asarray(a) for a in tf.to_numpy(tcfg, ts_)],
    )
    probes = jnp.asarray(np.concatenate([batch, _keys(99, 200)]))
    np.testing.assert_array_equal(
        np.asarray(jf.contains(jcfg, back, probes)),
        tf.contains(tcfg, ts_, _tkeys(np.asarray(probes))).numpy(),
    )
    return ts_


@pytest.mark.parametrize("when", ["idle", "mid-settle", "mid-migration"])
def test_numpy_round_trip_of_a_steady_state(when):
    batch = _keys(50, 32, lo=2**31)
    jcfg, jst = _Jax.make(q=10, r=16, buf_q=7, chunk=32)
    if when == "idle":
        jst = jf.insert(jcfg, jst, jnp.asarray(_keys(20, 600)))
    else:
        jcfg, jst = _mid_settle(_Jax)
        assert _settling(jst) and not bool(jst.clean)
    if when == "mid-migration":
        jcfg, jst = jir.begin_restructure(jcfg, jst, chunk=96, new_q=11)
        jst = jf.insert(jcfg, jst, jnp.asarray(_keys(60, 16, lo=2**31)))
        assert bool(jst.cursor < jst.src_n)
    if when == "mid-migration":
        src, dst, buf, chunk, wrap, src_len = jcfg
        tcfg = tir.MigratingQFConfig(
            *(QFilterConfig(*c) for c in (src, dst, buf)),
            chunk, ts.SteadyQFConfig(*wrap), src_len,
        )
    else:
        tcfg = ts.SteadyQFConfig(*jcfg)
    ts_ = _round_trip(jcfg, jst, tcfg, batch)
    assert isinstance(tf.stats(tcfg, ts_)["n"], torch.Tensor)
