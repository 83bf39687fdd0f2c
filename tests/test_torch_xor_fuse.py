"""The port's frozen tier against the JAX package's, bit for bit.

The same numpy keys go through ``repro`` and ``repro_torch`` (state on
the CPU):

* ``core/fuse_filter.py``: the hash, and ``freeze_keys``/
  ``freeze_stream`` with duplicates, a seed retry, a peel that fails
  every seed, and a stream over capacity;
* the ``fuse_probe`` kernel's plain version (what its wrapper runs for
  CPU tensors: the hash and the three gathers from canonical
  fingerprints) against the JAX package's ``fuse_hash`` and both
  packages' ``ref`` oracle at several seeds, cell widths and segment
  geometries, and the port's ``ops.fuse_contains`` against the JAX
  Pallas kernel run by the interpreter;
* the ``xor_fuse`` family through make/contains/probe/extend/merge/
  grow/shrink, and the cascade's ``frozen_below`` mode through a 4:1
  ingest stream whose merge-downs re-expand and re-peel frozen levels,
  under both backend spellings of the port;
* the numpy round trips of frozen states.

Integer results and float32 counters updated in the same order are
compared exactly; the fp rates are held to their bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.core import cost_model as jcost
from repro.core import fuse_filter as jfuse
from repro.filters import xor_fuse as jxor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import filters as tf
from repro_torch.core import cost_model as tcost
from repro_torch.core import fuse_filter as tfuse
from repro_torch.core import quotient_filter as tqf
from repro_torch.filters import cascade as tcascade
from repro_torch.filters import xor_fuse as txor
from repro_torch.kernels import fuse_probe, ops
from repro_torch.kernels import ref as tref


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _assert_same_state(jstate, tcfg, tstate, what=""):
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    tleaves = tf.to_numpy(tcfg, tstate)
    assert len(jleaves) == len(tleaves), what
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _assert_same_fuse(js, ts, what=""):
    """A core FuseState of each package, field by field."""
    for name, a, b in zip(js._fields, js, ts):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int64), b.numpy().astype(np.int64),
            err_msg=f"{what} {name}",
        )


# ---------------------------------------------------------------------------
# core: hash and construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "fuse_seed,fp_bits",
    [(0, 8), (12345, 14), (2**31 - 1, 28), (0x85EBCA6B & 0x7FFFFFFF, 1)],
)
def test_fuse_hash_matches_jax(fuse_seed, fp_bits):
    jc = jfuse.make_config(3000, p=39, fp_bits=fp_bits, seed=3)
    tc = tfuse.make_config(3000, p=39, fp_bits=fp_bits, seed=3)
    assert tuple(jc) == tuple(tc)
    keys = _keys(fp_bits, 2000)
    jq, jr = jfuse.key_fingerprints(jc, jnp.asarray(keys))
    tq, tr = tfuse.key_fingerprints(tc, _tkeys(keys))
    want = jfuse.fuse_hash(jc, jq, jr, jnp.int32(fuse_seed))
    for seed in (fuse_seed, torch.tensor(fuse_seed, dtype=torch.int32)):
        got = tfuse.fuse_hash(tc, tq, tr, seed)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    assert int(got[2].max()) < tc.slots


# (n, config seed, key seed): duplicates for every n > 10; the last one
# sits at design capacity and peels only at its third seed
FREEZE_CASES = [(1, 1, 1), (7, 7, 7), (100, 100, 100), (1000, 1000, 1000),
                (5000, 5000, 5000), (2000, 35, 1035)]


@pytest.mark.parametrize("n,seed,key_seed", FREEZE_CASES)
def test_freeze_keys_matches_jax(n, seed, key_seed):
    keys = _keys(key_seed, n)
    if n > 10 and seed == n:
        keys = np.concatenate([keys[: n - n // 10], keys[: n // 10]])  # duplicates
    jc = jfuse.make_config(n, p=26, seed=seed)
    tc = tfuse.make_config(n, p=26, seed=seed)
    before = dict(tfuse.peel_counts)
    js = jfuse.freeze_keys(jc, jnp.asarray(keys))
    ts = tfuse.freeze_keys(tc, _tkeys(keys))
    _assert_same_fuse(js, ts, f"n={n}")
    assert int(ts.n) == n
    if n > 10 and seed == n:
        assert int(ts.n_unique) < n  # the duplicates are one hyperedge each
    assert not bool(ts.overflow)
    attempts = tfuse.peel_counts["attempts"] - before["attempts"]
    assert attempts == (3 if seed == 35 else 1)
    assert tfuse.peel_counts["freezes"] == before["freezes"] + 1
    probes = np.concatenate([keys, _keys(key_seed + 1, 500)])
    hit = tfuse.contains(tc, ts, _tkeys(probes))
    np.testing.assert_array_equal(
        np.asarray(jfuse.contains(jc, js, jnp.asarray(probes))), hit.numpy()
    )
    assert hit[:n].all()


@pytest.mark.parametrize("case", ["every_seed_fails", "over_capacity", "empty"])
def test_freeze_stream_flags_overflow_as_jax(case):
    keys = _keys(1035, 2000)
    jc = jfuse.make_config(2000, p=26, seed=35)
    tc = tfuse.make_config(2000, p=26, seed=35)
    jq, jr = jfuse.key_fingerprints(jc, jnp.asarray(keys))
    jq, jr = jax.lax.sort((jq.astype(jnp.int32), jr), num_keys=2)
    tq, tr = tfuse.key_fingerprints(tc, _tkeys(keys))
    tq, tr = tqf._pad_sort(tq, tr, torch.ones(2000, dtype=torch.bool))
    if case == "every_seed_fails":  # this set peels only at the third seed
        js = jfuse.freeze_stream(jc, jq, jr, 2000, max_attempts=2)
        ts = tfuse.freeze_stream(tc, tq, tr, torch.tensor(2000), max_attempts=2)
        assert not ts.table.any()
    elif case == "over_capacity":  # the run keeps the first capacity entries
        jc = jfuse.make_config(1500, p=26, seed=35)
        tc = tfuse.make_config(1500, p=26, seed=35)
        js = jfuse.freeze_stream(jc, jq, jr, 2000)
        ts = tfuse.freeze_stream(tc, tq, tr, 2000)
        with pytest.raises(ValueError, match="exceeds frozen capacity"):
            tfuse.freeze(tc, tq, tr, 2000)
    else:
        js = jfuse.freeze_stream(jc, jq, jr, 0)
        ts = tfuse.freeze_stream(tc, tq, tr, 0)
        assert int(ts.fuse_seed) == 0
    _assert_same_fuse(js, ts, case)
    assert bool(ts.overflow) == (case != "empty")


def test_run_reexpansion_refreezes_the_same_table():
    tc = tfuse.make_config(1200, p=26)
    keys = _tkeys(_keys(5, 900))
    ts = tfuse.freeze_keys(tc, keys)
    fq, fr, n = tfuse.extract_run(tc, ts)
    again = tfuse.freeze(tc, fq, fr, n)
    for a, b in zip(ts, again):
        assert torch.equal(a, b)


def test_empty_config_and_capacity_checks_match_jax():
    for kw in (
        dict(capacity=0, p=26),
        dict(capacity=10, p=1),
        dict(capacity=10, p=26, fp_bits=29),
        dict(capacity=10, p=26, segment_length=3),
        dict(capacity=200_000_000, p=39),
    ):
        with pytest.raises(ValueError) as je:
            jfuse.make_config(**kw)
        with pytest.raises(ValueError) as te:
            tfuse.make_config(**kw)
        assert str(te.value) == str(je.value)
    tc = tfuse.make_config(100, p=26)
    with pytest.raises(ValueError, match="exceeds frozen capacity"):
        tfuse.freeze_keys(tc, _tkeys(_keys(6, 101)))
    st = tfuse.empty(tc, "cpu")
    assert not tfuse.contains(tc, st, _tkeys(_keys(4, 512))).any()


# ---------------------------------------------------------------------------
# the fuse_probe kernel's plain version and the kernel path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _frozen_pair(n=3000, seed=9):
    jc = jfuse.make_config(n, p=26, seed=seed)
    tc = tfuse.make_config(n, p=26, seed=seed)
    keys = _keys(7, n)
    js = jfuse.freeze_keys(jc, jnp.asarray(keys))
    return jc, tc, js, tfuse.freeze_keys(tc, _tkeys(keys))


def _geometry(cfg):
    return cfg.segment_length, cfg.segment_count, cfg.fp_bits


def test_fuse_probe_plain_matches_oracles():
    jc, tc, js, ts = _frozen_pair()
    probes = np.concatenate([_keys(7, 3000)[:600], _keys(8, 600)])
    jq, jr = jfuse.key_fingerprints(jc, jnp.asarray(probes))
    jp = jfuse.fuse_hash(jc, jq, jr, js.fuse_seed)
    tq, tr = tfuse.key_fingerprints(tc, _tkeys(probes))
    tp = [x.to(torch.int32) for x in tfuse.fuse_hash(tc, tq, tr, ts.fuse_seed)]
    fq, fr = tq.to(torch.int32), tr.to(torch.int32)
    args = (ts.fuse_seed, *_geometry(tc))
    got = fuse_probe.fuse_probe(ts.table, fq, fr, *args)
    assert fuse_probe.fuse_probe.launches == 0  # CPU tensors: no launch
    assert torch.equal(got, fuse_probe.fuse_probe_plain(ts.table, fq, fr, *args))
    assert torch.equal(got, tref.fuse_probe_ref(ts.table, *tp))
    want = jref.fuse_probe_ref(js.table, *jp)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got[:600].all()
    # queries in any order: a permuted batch gives the permuted answer
    perm = torch.randperm(1200, generator=torch.Generator().manual_seed(0))
    permuted = fuse_probe.fuse_probe(ts.table, fq[perm], fr[perm], *args)
    assert torch.equal(permuted, got[perm])
    with pytest.raises(TypeError):  # the kernel takes int32 fingerprints
        fuse_probe.fuse_probe(ts.table, tq, tr, *args)
    with pytest.raises(TypeError):  # and the state's int32 seed
        fuse_probe.fuse_probe(ts.table, fq, fr, ts.fuse_seed.long(), *_geometry(tc))
    with pytest.raises(ValueError):
        fuse_probe.fuse_probe(ts.table, fq, fr[:5], *args)
    with pytest.raises(ValueError):  # a table of another geometry
        fuse_probe.fuse_probe(ts.table[:-1], fq, fr, *args)
    L, C, f = _geometry(tc)
    for bad in ((L + 1, C, f), (L, 1 << 15, f), (L, C, 29), (L, C, 0)):
        with pytest.raises(ValueError):
            fuse_probe.fuse_probe(ts.table, fq, fr, ts.fuse_seed, *bad)


@functools.lru_cache(maxsize=None)
def _frozen_at(fp_bits, capacity, segment_length):
    """A port frozen filter at p = 39 (the main path's width) and its keys."""
    tc = tfuse.make_config(capacity, p=39, fp_bits=fp_bits, seed=3,
                           segment_length=segment_length)
    keys = _keys(fp_bits + capacity, capacity)
    return tc, tfuse.freeze_keys(tc, _tkeys(keys)), keys


@pytest.mark.parametrize("fp_bits", [1, 8, 14, 28])
@pytest.mark.parametrize("capacity,segment_length", [(3000, None), (500, 64)])
def test_fuse_probe_hashes_as_jax(fp_bits, capacity, segment_length):
    """The wrapper on CPU tensors, from canonical fingerprints, against the
    JAX package's ``fuse_hash`` and its ``fuse_probe_ref`` oracle on the
    same table, at the state's seed and at others, as tensors and ints."""
    tc, ts, keys = _frozen_at(fp_bits, capacity, segment_length)
    jc = jfuse.make_config(capacity, p=39, fp_bits=fp_bits, seed=3,
                           segment_length=segment_length)
    assert tuple(jc) == tuple(tc)
    assert not bool(ts.overflow)
    probes = np.concatenate([keys, _keys(99, 700)])
    jq, jr = jfuse.key_fingerprints(jc, jnp.asarray(probes))
    tq, tr = tfuse.key_fingerprints(tc, _tkeys(probes))
    fq, fr = tq.to(torch.int32), tr.to(torch.int32)  # fr: the uint32 bit pattern
    jtable = jnp.asarray(ts.table.numpy().view(np.uint32))
    own = int(ts.fuse_seed)
    seeds = [ts.fuse_seed, own, 0, 5, 2**31 - 1, torch.tensor(12345, dtype=torch.int32)]
    for seed in seeds:
        got = fuse_probe.fuse_probe(ts.table, fq, fr, seed, *_geometry(tc))
        jseed = jnp.int32(int(seed))
        want = jref.fuse_probe_ref(jtable, *jfuse.fuse_hash(jc, jq, jr, jseed))
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=str(seed))
        if int(seed) == own:
            assert got[:capacity].all()
@pytest.mark.parametrize(
    "nq,empty", [(16, False), (777, False), (4096, False), (300, True)]
)
def test_fuse_contains_matches_interpreted_kernel(nq, empty):
    jc, tc, js, ts = _frozen_pair()
    if empty:
        js, ts = jfuse.empty(jc), tfuse.empty(tc, "cpu")
    mixed = np.concatenate([_keys(7, 3000)[: nq // 2], _keys(8, nq - nq // 2)])
    want = jops.fuse_contains(jc, js, jnp.asarray(mixed), mode="interpret")
    got = ops.fuse_contains(tc, ts, _tkeys(mixed))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, tfuse.contains(tc, ts, _tkeys(mixed)))
    assert bool(got[: nq // 2].all()) != empty


# ---------------------------------------------------------------------------
# the xor_fuse family
# ---------------------------------------------------------------------------


class _JaxXor:
    make = staticmethod(lambda **kw: jf.make("xor_fuse", **kw))
    keys = staticmethod(jnp.asarray)
    extend = staticmethod(jxor.extend)
    f = jf


class _TorchXor:
    make = staticmethod(lambda **kw: tf.make("xor_fuse", device="cpu", **kw))
    keys = staticmethod(_tkeys)
    extend = staticmethod(txor.extend)
    f = tf


def _xor_stream(pkg, backend):
    """make(keys=) -> probe -> extend -> merge -> grow -> shrink, every observation."""
    f, k = pkg.f, pkg.keys
    ka, kb, kc = _keys(50, 600), _keys(51, 400), _keys(52, 300)
    probes = np.concatenate([ka[::3], kb[::5], _keys(53, 700)])
    seen = []
    cfg, st = pkg.make(capacity=1500, p=26, keys=k(ka), backend=backend)
    seen.append(("make", cfg, st))
    seen.append(("contains", cfg, f.contains(cfg, st, k(probes))))
    st, hit = f.probe(cfg, st, k(probes))
    seen += [("probe", cfg, st), ("probe hits", cfg, hit)]
    st = pkg.extend(cfg, st, k(kb))
    seen.append(("extend", cfg, st))
    _, other = pkg.make(capacity=1500, p=26, keys=k(kc), backend=backend)
    st = f.merge(cfg, st, other)
    seen.append(("merge", cfg, st))
    seen.append(("needs_resize", cfg, f.needs_resize(cfg, st)))
    cfg, st = f.grow(cfg, st)
    seen.append(("grow", cfg, st))
    seen.append(("needs_shrink", cfg, f.needs_shrink(cfg, st)))
    cfg, st = f.shrink(cfg, st)
    seen.append(("shrink", cfg, st))
    seen.append(("contains after", cfg, f.contains(cfg, st, k(probes))))
    return seen


@functools.lru_cache(maxsize=None)
def _jax_xor_stream():
    return _xor_stream(_JaxXor, "reference")


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_xor_fuse_stream_matches_jax(backend):
    jseen = _jax_xor_stream()
    tseen = _xor_stream(_TorchXor, backend)
    assert [s for s, *_ in tseen] == [s for s, *_ in jseen]
    for (step, jcfg, j), (_, tcfg, t) in zip(jseen, tseen):
        assert tuple(jcfg)[:6] == tuple(tcfg)[:6], step
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=step)
        else:
            _assert_same_state(j, tcfg, t, step)
    (_, jcfg, jst), (_, tcfg, tst) = jseen[-2], tseen[-2]
    assert tcfg.capacity == 1500 and int(tst.core.n) == 1300
    assert int(tst.io.rand_page_reads) == tcost.FUSE_PROBE_READS * (200 + 80 + 700)
    jstats, tstats = jf.stats(jcfg, jst), tf.stats(tcfg, tst)
    assert set(tstats) == set(jstats)
    for name, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(jstats[name]), np.asarray(v), name)
    ka, kb, kc = _keys(50, 600), _keys(51, 400), _keys(52, 300)
    assert tf.contains(tcfg, tst, _tkeys(np.concatenate([ka, kb, kc]))).all()


def test_xor_fuse_family_guards_and_capabilities():
    spec = dict(device="cpu", capacity=600, p=26)
    cfg, sa = tf.make("xor_fuse", keys=_tkeys(_keys(51, 400)), **spec)
    _, sb = tf.make("xor_fuse", keys=_tkeys(_keys(52, 400)), **spec)
    with pytest.raises(ValueError, match="exceeds frozen capacity"):
        tf.merge(cfg, sa, sb)
    with pytest.raises(ValueError, match="below the current population"):
        tf.resize(cfg, sa, capacity=300)
    for op in (tf.insert, tf.delete):
        with pytest.raises(tf.UnsupportedOpError) as ei:
            op(cfg, sa, _tkeys(_keys(40, 16)))
        assert ei.value.family == "xor_fuse"
        assert ei.value.hint == jf.by_name("xor_fuse").op_hints[ei.value.op]
    assert not tf.supports("xor_fuse", "insert") and not tf.supports(cfg, "delete")
    cfg2, st2 = tf.make("xor_fuse", device="cpu", **cfg._asdict())  # snapshot spec
    assert cfg2 == cfg and int(st2.core.n) == 0
    with pytest.raises(ValueError):
        tf.make("xor_fuse", device="cpu", p=26)
    with pytest.raises(ValueError):
        tf.make("xor_fuse", device="cpu", capacity=10, backend="triton")


# ---------------------------------------------------------------------------
# the cascade's frozen_below mode
# ---------------------------------------------------------------------------

RAM_Q = 8
CASCADE_BATCHES = 64
CASCADE_KEYS = 4 * int(0.75 * 2**RAM_Q)  # the 4:1 stream: merge-downs every 16 batches


def _cascade_spec(levels, frozen_below, backend):
    return dict(ram_q=RAM_Q, p=26, fanout=2, levels=levels, frozen_below=frozen_below,
                backend=backend)


# the configurations whose stream ends in a merge with a second cascade
# (one: the JAX package's merge compiles for seconds per configuration)
MERGED = {(3, 1)}


def _cascade_stream(f, make, k, spec):
    """Ingest the 4:1 stream; the state after every merge-down, then a
    probe, and (for ``MERGED``) a merge with a second frozen cascade."""
    cfg, st = make(spec)
    keys = _keys(60, CASCADE_KEYS)
    step = CASCADE_KEYS // CASCADE_BATCHES
    seen = []
    for b in range(CASCADE_BATCHES):
        st = f.insert(cfg, st, k(keys[b * step : (b + 1) * step]))
        if (b + 1) % 16 == 0:
            seen.append((f"after {b + 1} batches", st))
    probes = np.concatenate([keys[::7], _keys(61, 400)])
    probed, hit = f.probe(cfg, st, k(probes))
    seen += [("probe", probed), ("probe hits", hit)]
    seen.append(("contains", f.contains(cfg, st, k(probes))))
    if (spec["levels"], spec["frozen_below"]) not in MERGED:
        return cfg, seen
    _, other = make(spec)
    other = f.insert(cfg, other, k(_keys(62, 150)))
    seen.append(("merge", f.merge(cfg, st, other)))
    return cfg, seen


@functools.lru_cache(maxsize=None)
def _jax_cascade_stream(levels, frozen_below):
    spec = _cascade_spec(levels, frozen_below, "reference")
    merge = jax.jit(jf.merge, static_argnums=0)

    class F:
        insert, probe, contains = jf.insert, jf.probe, jf.contains

    F.merge = staticmethod(merge)
    return _cascade_stream(F, lambda s: jf.make("cascade", **s), jnp.asarray, spec)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("levels,frozen_below", [(3, 0), (3, 1), (4, 0), (4, 1)])
def test_frozen_cascade_stream_matches_jax(levels, frozen_below, backend):
    jcfg, jseen = _jax_cascade_stream(levels, frozen_below)
    spec = _cascade_spec(levels, frozen_below, backend)
    make = lambda s: tf.make("cascade", device="cpu", **s)
    tcfg, tseen = _cascade_stream(tf, make, _tkeys, spec)
    assert [s for s, _ in tseen] == [s for s, _ in jseen]
    for (step, j), (_, t) in zip(jseen, tseen):
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=step)
        else:
            _assert_same_state(j, tcfg, t, step)
    states = dict(tseen)
    # after batch 32 level 0 holds 384 keys: with frozen_below=0 it was
    # re-expanded from its run and re-peeled at its design capacity
    counts = [
        [int(s.n) for s in states[f"after {b} batches"].levels]
        for b in (16, 32, 48, 64)
    ]
    assert counts == [[192] + [0] * (levels - 1), [384] + [0] * (levels - 1),
                      [0, 576] + [0] * (levels - 2), [192, 576] + [0] * (levels - 2)]
    assert isinstance(states["after 48 batches"].levels[1], tfuse.FuseState)
    final = states["after 64 batches"]
    assert not bool(tf.stats(tcfg, final)["overflow"])
    assert states["probe hits"][: len(_keys(60, CASCADE_KEYS)[::7])].all()
    jstats, tstats = jf.stats(jcfg, jseen[3][1]), tf.stats(tcfg, final)
    assert set(tstats) == set(jstats)
    for name, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(jstats[name]), np.asarray(v), name)
    assert vars(tf.to_iolog(final.io)) == vars(jf.to_iolog(jseen[3][1].io))


@pytest.mark.parametrize("frozen_below", [None, 1])
def test_cascade_contains_with_empty_levels_matches_jax(frozen_below):
    """``contains`` on the kernel path where the 4:1 stream leaves levels
    empty between live ones: after 48 batches level 1 alone holds keys,
    after 63 Q0 and level 1 (the main path's mid-stream checkpoint)."""
    jspec = _cascade_spec(4, frozen_below, "reference")
    jcfg, jst = jf.make("cascade", **jspec)
    tcfg, tst = tf.make("cascade", device="cpu", **dict(jspec, backend="pallas"))
    keys = _keys(60, CASCADE_KEYS)
    step = CASCADE_KEYS // CASCADE_BATCHES
    probes = np.concatenate([keys[::7], _keys(61, 400)])
    counts = {}
    for b in range(63):
        batch = keys[b * step : (b + 1) * step]
        jst = jf.insert(jcfg, jst, jnp.asarray(batch))
        tst = tf.insert(tcfg, tst, _tkeys(batch))
        if b + 1 in (48, 63):
            counts[b + 1] = [int(s.n) for s in (tst.q0, *tst.levels)]
            want = np.asarray(jf.contains(jcfg, jst, jnp.asarray(probes)))
            got = tf.contains(tcfg, tst, _tkeys(probes))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(b + 1))
            held = keys[: (b + 1) * step][::7].shape[0]
            assert got[:held].all()
    assert counts == {48: [0, 0, 576, 0, 0], 63: [180, 0, 576, 0, 0]}


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("frozen_below", [0, 1])
def test_frozen_probe_reads_match_cost_model(frozen_below, backend):
    spec = _cascade_spec(4, frozen_below, backend)
    cfg, st = tf.make("cascade", device="cpu", **spec)
    keys = _keys(30, 2048)
    for i in range(0, 2048, 128):
        st = tf.insert(cfg, st, _tkeys(keys[i : i + 128]))
    misses = _keys(31, 1000)
    misses = misses[~tf.contains(cfg, st, _tkeys(misses)).numpy()]  # drop the fps
    before = int(st.io.rand_page_reads)
    st2, hit = tf.probe(cfg, st, _tkeys(misses))
    assert not hit.any()
    nonempty = [int(c) > 0 for c in tf.stats(cfg, st)["level_counts"]]
    frozen = [cfg.is_frozen(i) for i in range(cfg.levels)]
    assert any(n and fz for n, fz in zip(nonempty, frozen))
    want = jcost.cascade_probe_reads(misses.shape[0], nonempty, frozen)
    assert int(st2.io.rand_page_reads) - before == want
    assert tcost.cascade_probe_reads(misses.shape[0], nonempty, frozen) == want
    with pytest.raises(tf.UnsupportedOpError) as ei:
        tf.delete(cfg, st, _tkeys(keys[:4]))
    assert ei.value.op == "delete"
    with pytest.raises(tf.UnsupportedOpError):
        tcascade.delete(cfg, st, _tkeys(keys[:4]))
    assert tf.supports("cascade", "delete") and not tf.supports(cfg, "delete")


def test_frozen_geometry_limits_match_jax():
    # at ram_q = 24 a frozen level 3 needs 2**15 segments or more
    spec = dict(ram_q=24, p=39, fanout=2, levels=6, frozen_below=1)
    with pytest.raises(ValueError) as je:
        jf.make("cascade", **spec)
    with pytest.raises(ValueError) as te:
        tf.make("cascade", device="cpu", **spec)
    assert str(te.value) == str(je.value) and "segment_count" in str(te.value)
    ok = tcascade.CascadeConfig(**dict(spec, levels=3))
    tcascade._check_geometry(ok)  # geometry only: nothing allocated
    assert [ok.fuse_cfg(i).segment_count for i in (1, 2)] == [13822, 27646]
    assert ok.fuse_cfg(1).fp_bits == 14
    with pytest.raises(ValueError, match="frozen_below"):
        tf.make("cascade", device="cpu", ram_q=6, p=22, frozen_below=-1)


# ---------------------------------------------------------------------------
# numpy round trips of frozen states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cascade", "xor_fuse"])
def test_frozen_numpy_round_trip(name):
    if name == "cascade":
        jcfg, jseen = _jax_cascade_stream(3, 1)
        js = jseen[2][1]  # after 48 batches: all keys in frozen level 1
        tcfg, _ = tf.make(name, device="cpu", **jcfg._asdict())
        keys = _keys(60, CASCADE_KEYS)[:576]
    else:
        keys = _keys(70, 576)
        jcfg, js = jf.make(name, p=26, keys=jnp.asarray(keys))
        tcfg = txor.XorFuseConfig(*jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(js)
    ts = tf.from_numpy(tcfg, [np.asarray(x) for x in leaves], device="cpu")
    _assert_same_state(js, tcfg, ts)
    assert tf.contains(tcfg, ts, _tkeys(keys)).all()
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in tf.to_numpy(tcfg, ts)]
    )
    assert bool(jf.contains(jcfg, back, jnp.asarray(keys)).all())
    bad = [np.asarray(x) for x in leaves]
    i = [k for k, (n, _) in enumerate(tf._leaves(ts)) if n == "run_q"][0]
    bad[i] = bad[i].astype(np.int64)
    with pytest.raises(TypeError):
        tf.from_numpy(tcfg, bad, device="cpu")
