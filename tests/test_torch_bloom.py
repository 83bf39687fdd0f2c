"""The port's Bloom path against the JAX package's, bit for bit.

The same numpy keys go through ``repro`` and ``repro_torch`` (state on
the CPU):

* the two kernels' plain versions (what a wrapper runs for CPU tensors)
  against the JAX Pallas kernels run by the interpreter, as
  ``tests/test_kernels.py`` runs them, and against both packages'
  ``ref`` oracles;
* the ``bloom`` and ``blocked_bloom`` families, plain and counting,
  under both backend spellings on the port, against the JAX family
  under ``"reference"`` and under ``"pallas"`` with its kernels
  interpreted, after every step of an insert/delete/merge/grow/shrink
  stream;
* ``core/bloom.py``.

Integer results are compared exactly; ``fill`` and ``load`` are float32
means, which may differ in the last bits (relative 1e-6).
"""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.core import bloom as jbloom
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import filters as tf
from repro_torch.core import bloom as tbloom
from repro_torch.kernels import bloom_block, ops
from repro_torch.kernels import ref as tref

INT32_MAX = 2**31 - 1


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _blocked_idx(seed, n, ncells, k=4, nblocks=32):
    """(n, k) int32 indices with blocked locality over ``nblocks`` bins."""
    rng = np.random.default_rng(seed)
    span = ncells // nblocks
    blk = rng.integers(0, nblocks, n)
    return (blk[:, None] * span + rng.integers(0, span, (n, k))).astype(np.int32)


def _count_case(case):
    ncells = 1 << 12
    if case == "blocked":
        return _blocked_idx(0, 3000, ncells).reshape(-1), ncells
    if case == "dense_bins":  # tiles denser than the TPU kernel's item window
        rng = np.random.default_rng(1)
        hot = rng.integers(0, 256, 6000).astype(np.int32)
        return np.concatenate([hot, _blocked_idx(2, 1000, ncells).reshape(-1)]), ncells
    # masked keys: INT32_MAX sentinels count nothing
    idx = _blocked_idx(3, 500, ncells, nblocks=8).reshape(-1)
    return np.concatenate([idx, np.full(64, INT32_MAX, np.int32)]), ncells


@pytest.mark.parametrize("case", ["blocked", "dense_bins", "sentinels"])
def test_bloom_count_matches_jax_kernel(case):
    idx, ncells = _count_case(case)
    got = bloom_block.bloom_count(_t(idx), ncells)
    assert got.dtype == torch.int32 and got.shape == (ncells,)
    jidx = jnp.asarray(idx)
    kernel = jops.bloom_counts(jidx, ncells, mode="interpret", block_s=128)
    for want in (kernel, jref.bloom_count_ref(jidx, ncells)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tref.bloom_count_ref(_t(idx), ncells), got)
    assert torch.equal(ops.bloom_counts(_t(idx), ncells), got)
    assert int(got.sum()) == int((idx != INT32_MAX).sum())


@pytest.mark.parametrize(
    "cell_dtype, B, k, wblk",
    [
        (np.uint8, 1000, 4, 4096),  # B not a multiple of the TPU's 128-row tile
        (np.uint16, 777, 7, 4096),
        (np.uint8, 512, 2, 256),  # bins wider than the window: all overflow
        # the card's kernel reads cells in groups of 2: k = 1, 3, 5 and 13
        # end in a ragged group, k = 12 in whole ones; no B is a multiple
        # of its 256-thread block
        (np.uint8, 300, 1, 4096),
        (np.uint16, 513, 3, 4096),
        (np.uint8, 257, 5, 4096),
        (np.uint8, 1000, 12, 4096),
        (np.uint16, 999, 13, 4096),
    ],
)
def test_bloom_probe_matches_jax_kernel(cell_dtype, B, k, wblk):
    ncells = 1 << 12
    ins = _blocked_idx(4, 600, ncells, k=k)
    rng = np.random.default_rng(5)
    cells = np.zeros(ncells, cell_dtype)
    # counting cells hold values up to 0xFFFF, some of them past int16's max
    cells[ins.reshape(-1)] = rng.integers(1, 0x10000 if cell_dtype == np.uint16 else 2,
                                          ins.size)
    queries = np.concatenate([ins[: B // 3], _blocked_idx(6, B - B // 3, ncells, k=k)])
    tcells = _t(cells.view(np.int16) if cell_dtype == np.uint16 else cells)
    got = bloom_block.bloom_probe(tcells, _t(queries))
    assert got.dtype == torch.bool and got.shape == (B,)
    jcells, jq = jnp.asarray(cells), jnp.asarray(queries)
    kernel = jops.bloom_probe(jcells, jq, mode="interpret", wblk=wblk)
    for want in (kernel, jref.bloom_probe_ref(jcells.astype(jnp.int32), jq)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tref.bloom_probe_ref(tcells, _t(queries)), got)
    assert torch.equal(ops.bloom_probe(tcells, _t(queries)), got)
    assert got[: B // 3].all()


def test_kernel_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        bloom_block.bloom_count(torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        bloom_block.bloom_count(torch.zeros(4, dtype=torch.int32), 2**31)
    with pytest.raises(TypeError):
        bloom_block.bloom_probe(torch.zeros(8, dtype=torch.int32),
                                torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        bloom_block.bloom_probe(torch.zeros(8, dtype=torch.uint8),
                                torch.zeros(6, dtype=torch.int32))
    with pytest.raises(ValueError):
        bloom_block.bloom_probe(torch.zeros(8, dtype=torch.uint8, device="meta"),
                                torch.zeros(2, 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

SPECS = {
    "bloom": dict(m_bits=6000, k=4),  # not a power of two, nor a block multiple
    "blocked_bloom": dict(m_bits=6000, k=4, block_bits=512),
}
BATCH = 160


def _stream(f, name, spec, make, keys):
    """Run the test stream through façade ``f``; return every observation."""
    seen = []
    cfg, st = make(name, spec)
    base = _keys(1, 3 * BATCH)
    probes = keys(np.concatenate([base[::4], _keys(2, 300)]))
    for i in range(0, 3 * BATCH, BATCH):
        st = f.insert(cfg, st, keys(base[i : i + BATCH]))
        seen.append(("insert", st))
    # a padded batch: only the first k rows count
    st = f.insert(cfg, st, keys(_keys(3, BATCH)), 100)
    seen += [("padded insert", st), ("hits", f.contains(cfg, st, probes))]
    if cfg.counting:  # duplicates within the batch take one copy each
        batch = np.concatenate([base[:50], base[:10], _keys(3, 30)])
        st = f.delete(cfg, st, keys(batch), 80)
        seen += [("delete", st), ("hits after delete", f.contains(cfg, st, probes))]
    other = f.insert(cfg, make(name, spec)[1], keys(_keys(4, BATCH)))
    st = f.merge(cfg, st, other)
    seen += [("merge", st), ("needs_resize", f.needs_resize(cfg, st))]
    cfg, st = f.grow(cfg, st)
    seen += [("grow", st), ("hits after grow", f.contains(cfg, st, probes))]
    st = f.insert(cfg, st, keys(_keys(5, BATCH)))
    seen += [("insert after grow", st), ("needs_shrink", f.needs_shrink(cfg, st))]
    cfg, st = f.shrink(cfg, st)
    seen += [("shrink", st), ("hits after shrink", f.contains(cfg, st, probes))]
    cfg, st = f.resize(cfg, st, factor=4)
    seen += [("resize", st), ("stats", f.stats(cfg, st))]
    return cfg, seen


@functools.lru_cache(maxsize=None)
def _jax_stream(name, counting, backend):
    spec = dict(SPECS[name], counting=counting, backend=backend)
    # under "pallas" the JAX package's Bloom kernels run in the interpreter
    mode = {"REPRO_KERNEL_MODE": "interpret"} if backend == "pallas" else {}
    with mock.patch.dict(os.environ, mode):
        return _stream(jf, name, spec, lambda n, s: jf.make(n, **s), jnp.asarray)


def _assert_same(step, j, tcfg, t):
    if isinstance(t, dict):  # stats
        assert set(t) == set(j), step
        for key in ("n", "cells_set", "size_bytes"):
            assert int(np.asarray(j[key])) == int(t[key]), key
        for key in ("fill", "load"):
            np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=1e-6)
    elif isinstance(t, torch.Tensor):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=step)
    else:  # a state: its leaves as the JAX package holds them
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j)]
        tl = tf.to_numpy(tcfg, t)
        assert [a.dtype for a in jl] == [a.dtype for a in tl], step
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b, err_msg=step)


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("counting", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_stream_matches_jax(name, counting, backend, jax_backend):
    jcfg, jseen = _jax_stream(name, counting, jax_backend)
    spec = dict(SPECS[name], counting=counting, backend=backend)
    tcfg, tseen = _stream(
        tf, name, spec, lambda n, s: tf.make(n, device="cpu", **s), _tkeys
    )
    assert tuple(tcfg)[:-1] == tuple(jcfg)[:-1]  # the same geometry after resizes
    assert [s for s, _ in tseen] == [s for s, _ in jseen]
    for (step, j), (_, t) in zip(jseen, tseen):
        _assert_same(step, j, tcfg, t)
    assert dict(tseen)["hits"][: 3 * BATCH // 4].all()  # no false negative


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_counting_cells_wrap_and_saturate_as_uint16(name, backend):
    """Cells near 0xFFFF, carried across from JAX states: merge and insert
    wrap them, delete wraps them back, shrink saturates the fold."""
    from repro.filters.bloom_filter import BloomState

    spec = dict(SPECS[name], m_bits=6144, counting=True, backend=backend)  # foldable
    jcfg, _ = jf.make(name, **dict(spec, backend="reference"))
    tcfg, _ = tf.make(name, device="cpu", **spec)
    rng = np.random.default_rng(7)
    ncells = jf.make(name, **spec)[1].cells.shape[0]

    def jstate(seed):
        cells = np.random.default_rng(seed).integers(0xFFF0, 0x10000, ncells)
        cells[rng.random(ncells) < 0.5] = 0
        return BloomState(cells=jnp.asarray(cells.astype(np.uint16)), n=jnp.int32(9))

    def port(js):
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
        return tf.from_numpy(tcfg, leaves, device="cpu")

    ja, jb = jstate(8), jstate(9)
    ta, tb = port(ja), port(jb)
    _assert_same("round trip", ja, tcfg, ta)
    keys = _keys(10, 300)
    steps = [
        ("merge", lambda f, c, a, b, k: f.merge(c, a, b)),
        ("insert", lambda f, c, a, b, k: f.insert(c, a, k, 250)),
        ("delete", lambda f, c, a, b, k: f.delete(c, a, k[:100])),
    ]
    for step, op in steps:
        ja = op(jf, jcfg, ja, jb, jnp.asarray(keys))
        ta = op(tf, tcfg, ta, tb, _tkeys(keys))
        _assert_same(step, ja, tcfg, ta)
    jcfg, ja = jf.shrink(jcfg, ja)
    tcfg, ta = tf.shrink(tcfg, ta)
    assert (np.asarray(ja.cells) == 0xFFFF).any()  # the fold saturated somewhere
    _assert_same("shrink", ja, tcfg, ta)
    probes = np.concatenate([keys, _keys(11, 200)])
    np.testing.assert_array_equal(
        np.asarray(jf.contains(jcfg, ja, jnp.asarray(probes))),
        tf.contains(tcfg, ta, _tkeys(probes)).numpy(),
    )
    # and back: the port's state answers in the JAX package as it did here
    _, treedef = jax.tree_util.tree_flatten(ja)
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in tf.to_numpy(tcfg, ta)]
    )
    _assert_same("back", back, tcfg, ta)


def test_from_numpy_wants_counting_cells_as_uint16():
    tcfg, ts = tf.make("bloom", device="cpu", m_bits=128, k=3, counting=True)
    leaves = tf.to_numpy(tcfg, ts)
    assert leaves[0].dtype == np.uint16
    with pytest.raises(TypeError):
        tf.from_numpy(tcfg, [leaves[0].view(np.int16), leaves[1]], device="cpu")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_make_refuses_2_to_the_31_cells(name):
    spec = dict(SPECS[name], m_bits=2**31)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tf.make(name, device="meta", **spec)
    cfg, st = tf.make(name, device="meta", **dict(spec, m_bits=2**30))
    with pytest.raises(ValueError):
        tf.grow(cfg, st)


# ---------------------------------------------------------------------------
# core/bloom.py
# ---------------------------------------------------------------------------

EDGE_KEYS = np.concatenate(
    [np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32), _keys(12, 200)]
)


@pytest.mark.parametrize("m_bits", [64, 1_000_003, 4_294_967_291])
def test_bit_indices_match_jax(m_bits):
    """Sizes of a power of two, a prime, and the largest prime below 2**32,
    whose indices past 2**31 come back as the int32 wrap in both."""
    for seed in (0, 3, 12345):
        for k in (1, 12, 32):
            cfg = dict(m_bits=m_bits, k=k, seed=seed)
            want = np.asarray(jbloom.bit_indices(jbloom.BloomConfig(**cfg),
                                                 jnp.asarray(EDGE_KEYS)))
            got = tbloom.bit_indices(tbloom.BloomConfig(**cfg), _tkeys(EDGE_KEYS))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cfg))


@pytest.mark.parametrize("counting", [False, True])
def test_core_insert_delete_lookup_match_jax(counting):
    """A key inserted 300 times wraps its uint8 counters in both packages."""
    jcfg = jbloom.BloomConfig(m_bits=997, k=5, seed=2, counting=counting)
    tcfg = tbloom.BloomConfig(*jcfg)
    keys = np.concatenate([np.full(300, 12345, np.uint32), _keys(13, 100)])
    jbits = jbloom.insert(jcfg, jbloom.empty(jcfg), jnp.asarray(keys))
    tbits = tbloom.insert(tcfg, tbloom.empty(tcfg, "cpu"), _tkeys(keys))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    if counting:
        jbits = jbloom.counting_delete(jcfg, jbits, jnp.asarray(keys[:100]))
        tbits = tbloom.counting_delete(tcfg, tbits, _tkeys(keys[:100]))
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    else:
        with pytest.raises(ValueError):
            tbloom.counting_delete(tcfg, tbits, _tkeys(keys))
    probes = np.concatenate([keys[250:], _keys(14, 300)])
    np.testing.assert_array_equal(
        tbloom.lookup(tcfg, tbits, _tkeys(probes)).numpy(),
        np.asarray(jbloom.lookup(jcfg, jbits, jnp.asarray(probes))),
    )
    jp, jidx = jbloom.probes_until_reject(jcfg, jbits, jnp.asarray(probes))
    tp, tidx = tbloom.probes_until_reject(tcfg, tbits, _tkeys(probes))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tbloom.optimal_k(12 / np.log(2)) == jbloom.optimal_k(12 / np.log(2)) == 12
