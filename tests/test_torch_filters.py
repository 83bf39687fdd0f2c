"""The port's filter façade against the JAX package's, bit for bit.

The same numpy keys go through ``repro.filters`` and
``repro_torch.filters`` (state on the CPU) for ``qf``, ``buffered_qf``
and ``cascade``: after every step of one insert/delete/probe/merge
stream the states must have equal planes, ``n``, ``overflow`` and
``IOCounters`` fields, and equal hit masks.  Integer structures and
float32 counters updated in the same order: no tolerance.

The port runs the stream under both backend spellings.  The JAX side
runs it once per family, under ``backend="pallas"``: on the CPU that is
the JAX package's bit-exact lowering of its kernel path, whose states
equal its reference spelling's (``tests/test_kernels.py``), and it
compiles in a fraction of the time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro_torch import filters as tf

SPECS = {
    "qf": dict(q=9, r=14),
    "buffered_qf": dict(ram_q=7, disk_q=10, p=22),
    "cascade": dict(ram_q=6, p=22, fanout=2, levels=2),
}
BATCH = 96  # 0.75 * 2**7 = 96: every buffered_qf batch fills its RAM QF


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _assert_same_state(jstate, tcfg, tstate):
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    tleaves = tf.to_numpy(tcfg, tstate)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def _stream(f, name, spec, make, keys):
    """Run the test stream through façade ``f``; return every observation."""
    seen = []
    cfg, st = make(name, spec)
    for i in range(0, 5 * BATCH, BATCH):
        st = f.insert(cfg, st, keys(_keys(1, 5 * BATCH)[i : i + BATCH]))
        seen.append(("insert", st))
    # a padded batch: only the first k rows count
    st = f.insert(cfg, st, keys(_keys(1, BATCH)), 40)
    seen.append(("padded insert", st))
    probes = np.concatenate([_keys(1, 5 * BATCH)[::3], _keys(2, 400)])
    st, hit = f.probe(cfg, st, keys(probes))
    seen += [("probe", st), ("probe hits", hit)]
    # duplicates in the delete batch spill across the layers
    base = _keys(1, 5 * BATCH)
    st = f.delete(cfg, st, keys(np.concatenate([base[:50], base[:10], _keys(3, 20)])))
    seen.append(("delete", st))
    other = f.insert(cfg, make(name, spec)[1], keys(_keys(4, BATCH)))
    seen.append(("other", other))
    st = f.merge(cfg, st, other)
    seen.append(("merge", st))
    return cfg, seen


class _JaxFacade:
    """``repro.filters`` with merge and delete compiled whole: run eagerly,
    their ``lax.switch``/``lax.cond`` branches take seconds op by op."""

    insert, probe, contains = jf.insert, jf.probe, jf.contains
    merge = staticmethod(jax.jit(jf.merge, static_argnums=0))
    delete = staticmethod(jax.jit(jf.delete, static_argnums=0))


@functools.lru_cache(maxsize=None)
def _jax_stream(name):
    spec = dict(SPECS[name], backend="pallas")
    return _stream(_JaxFacade, name, spec, lambda n, s: jf.make(n, **s), jnp.asarray)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_stream_matches_jax(name, backend):
    spec = dict(SPECS[name], backend=backend)
    jcfg, jseen = _jax_stream(name)
    tcfg, tseen = _stream(
        tf, name, spec, lambda n, s: tf.make(n, device="cpu", **s), _tkeys
    )
    assert [k for k, _ in tseen] == [k for k, _ in jseen]
    for (step, j), (_, t) in zip(jseen, tseen):
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=step)
        else:
            _assert_same_state(j, tcfg, t)
    n_hits = _keys(1, 5 * BATCH)[::3].shape[0]
    # inserted keys probed: no false negative
    hits = dict(tseen)["probe hits"]
    assert hits[:n_hits].all()
    # contains is probe without the I/O accounting (as in the JAX package)
    probe_state = dict(tseen)["probe"]
    probes = np.concatenate([_keys(1, 5 * BATCH)[::3], _keys(2, 400)])
    assert torch.equal(tf.contains(tcfg, probe_state, _tkeys(probes)), hits)

    jm, tm = jseen[-1][1], tseen[-1][1]
    jstats, tstats = jf.stats(jcfg, jm), tf.stats(tcfg, tm)
    assert set(tstats) <= set(jstats)
    for k, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(jstats[k]), np.asarray(v), k)
    if name != "qf":
        assert vars(tf.to_iolog(tm.io)) == vars(jf.to_iolog(jm.io))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_numpy_round_trip_builds_in_one_package_queries_in_other(name):
    spec = dict(SPECS[name], backend="pallas")
    jcfg, js = jf.make(name, **spec)
    keys = _keys(5, BATCH)
    js = jf.insert(jcfg, js, jnp.asarray(keys))
    tcfg, _ = tf.make(name, device="cpu", **spec)

    leaves, treedef = jax.tree_util.tree_flatten(js)
    ts = tf.from_numpy(tcfg, [np.asarray(x) for x in leaves], device="cpu")
    assert tf.contains(tcfg, ts, _tkeys(keys)).all()
    _assert_same_state(js, tcfg, ts)

    ts = tf.insert(tcfg, ts, _tkeys(_keys(6, BATCH)))
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in tf.to_numpy(tcfg, ts)]
    )
    probes = np.concatenate([keys, _keys(6, BATCH)])
    assert bool(jf.contains(jcfg, back, jnp.asarray(probes)).all())


def test_from_numpy_rejects_wrong_leaves():
    tcfg, ts = tf.make("qf", device="cpu", q=6, r=8)
    leaves = tf.to_numpy(tcfg, ts)
    with pytest.raises(ValueError):
        tf.from_numpy(tcfg, leaves[:-1], device="cpu")
    bad = list(leaves)
    bad[0] = bad[0].view(np.int32)
    with pytest.raises(TypeError):
        tf.from_numpy(tcfg, bad, device="cpu")
    bad = list(leaves)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError):
        tf.from_numpy(tcfg, bad, device="cpu")


def test_unported_ops_raise_structured_errors():
    # the resize ops are ported now: every QF family binds them, and what
    # a config refuses still raises the structured error
    cfg, st = tf.make("qf", device="cpu", q=6, r=8)
    for name in ("qf", "buffered_qf", "cascade"):
        for op in ("grow", "resize", "shrink", "needs_resize", "needs_shrink"):
            assert tf.supports(name, op), (name, op)
    ccfg, cst = tf.make("cascade", device="cpu", ram_q=6, p=22, frozen_below=1)
    assert tf.supports(ccfg, "grow") and not tf.supports(ccfg, "delete")
    with pytest.raises(tf.UnsupportedOpError):
        tf.delete(ccfg, cst, torch.arange(4, dtype=torch.int32))
    assert tf.grow(ccfg, cst)[0].levels == ccfg.levels + 1
    assert tf.supports(cfg, "delete") and tf.supports("cascade", "probe")
    with pytest.raises(ValueError):
        tf.supports("qf", "grwo")
    assert tf.names() == (
        "blocked_bloom", "bloom", "buffered_qf", "cascade", "qf", "sharded_qf",
        "steady_qf", "xor_fuse",
    )


def test_pallas_backend_keeps_remainder_limit():
    with pytest.raises(ValueError):
        tf.make("qf", device="cpu", q=6, r=32, backend="pallas")
    with pytest.raises(ValueError):
        tf.make("qf", device="cpu", q=6, r=8, backend="triton")


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name", sorted(SPECS) + ["steady_qf"])
def test_empty_delete_returns_the_state_unchanged(name, backend):
    # the JAX package raises on a zero-key delete (in
    # quotient_filter._range_bsearch), so only the port is checked here
    from repro_torch.filters import steady

    spec = dict(SPECS.get(name, dict(q=9, r=12)), backend=backend)
    cfg, st = tf.make(name, device="cpu", **spec)
    st = tf.insert(cfg, st, np.arange(100, dtype=np.uint32))
    if name == "steady_qf":  # every steady delete settles the buffer first
        st = steady.settle_all(cfg, st)
    before = tf.to_numpy(cfg, st)
    after = tf.to_numpy(cfg, tf.delete(cfg, st, np.zeros(0, np.uint32)))
    assert len(after) == len(before)
    for i, (a, b) in enumerate(zip(before, after)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert int(tf.stats(cfg, tf.from_numpy(cfg, after, device="cpu"))["n"]) == 100
