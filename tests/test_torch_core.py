"""The port's fingerprint and quotient filter against the JAX package's.

Same numpy keys through ``repro.core`` and ``repro_torch.core`` (CPU
tensors); every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fingerprint as jfp
from repro.core import quotient_filter as jqf
from repro_torch.core import fingerprint as tfp
from repro_torch.core import fuse_filter as tfuse
from repro_torch.core import quotient_filter as tqf
from repro_torch.kernels import fingerprint as kfp


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    keys[:2] = [0, 0xFFFFFFFF]  # the edge keys
    return keys


def _t(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _same_state(js, ts):
    for f, a, b in zip(js._fields, js, ts):
        b = b.numpy().view(np.uint32) if f == "rem" else b.numpy()
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)


def _same_stream(jq, jr, tq, tr):
    np.testing.assert_array_equal(np.asarray(jq).astype(np.int64), tq.numpy())
    np.testing.assert_array_equal(np.asarray(jr).astype(np.int64), tr.numpy())


@pytest.mark.parametrize("seed", [0, 1, 7, 0xDEADBEEF, 2**32 - 1])
def test_hash_words_match(seed):
    keys = _keys(seed % 1000, 4000)
    jhi, jlo = jfp.hash2(jnp.asarray(keys), seed)
    thi, tlo = tfp.hash2(_t(keys), seed)
    np.testing.assert_array_equal(np.asarray(jhi).astype(np.int64), thi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo).astype(np.int64), tlo.numpy())


@pytest.mark.parametrize("p", [26, 39, 62])
def test_every_split_of_p_matches(p):
    # jfp.fingerprint is hash2 + two extract_bits; hashing once keeps the
    # JAX side to a few eager ops per split
    keys = _keys(3, 1000)
    hi, lo = jfp.hash2(jnp.asarray(keys), 5)
    for q in range(max(1, p - 32), min(30, p - 1) + 1):
        jq = jfp.extract_bits(hi, lo, 0, q)
        jr = jfp.extract_bits(hi, lo, q, p - q)
        tq, tr = tfp.fingerprint(_t(keys), q, p - q, seed=5)
        _same_stream(jq, jr, tq, tr)


# (q, r) pairs for the fingerprint kernel's wrapper: remainders inside the
# hi word (q + r <= 32, ending at bit 32 or before it) and straddling it
# into lo (p = 39 at the main path's split and the canonical one, q + r =
# 33 and 62), r = 32; fingerprint's q <= 30 never starts a slice in lo
SPLITS = [(1, 1), (12, 10), (16, 16), (1, 31), (30, 2), (1, 32), (20, 13), (30, 3),
          (24, 15), (7, 32), (30, 32), (29, 32), (13, 26)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_fingerprint_kernel_wrapper_matches_jax(seed, dtype):
    """The wrapper on CPU tensors (its plain version) against the JAX
    ``fingerprint``, for int32 keys (half with the high bit set), uint32
    keys and int64 keys whose low 32 bits are those keys."""
    keys = _keys(seed % 97, 1000)
    hi, lo = jfp.hash2(jnp.asarray(keys), seed)
    wide = keys.astype(np.int64) + (np.arange(1000, dtype=np.int64) - 500) * 2**32
    inputs = [_t(keys), torch.from_numpy(keys.copy()), torch.from_numpy(wide)]
    assert inputs[0].dtype == torch.int32 and (inputs[0] < 0).any()
    for q, r in SPLITS:
        jq = np.asarray(jfp.extract_bits(hi, lo, 0, q)).astype(np.int32)
        jr = np.asarray(jfp.extract_bits(hi, lo, q, r)).astype(np.uint32)
        if dtype == torch.int64:
            want = (jq.astype(np.int64), jr.astype(np.int64))
        else:
            want = (jq, jr.view(np.int32))
        for k in inputs:
            fq, fr = kfp.fingerprint(k, q, r, seed, dtype)
            assert fq.dtype == fr.dtype == dtype
            np.testing.assert_array_equal(fq.numpy(), want[0], err_msg=f"{q} {r}")
            np.testing.assert_array_equal(fr.numpy(), want[1], err_msg=f"{q} {r}")
    assert kfp.fingerprint.launches == 0  # CPU tensors: no launch


def test_fingerprint_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    keys = _t(_keys(0, 10))
    for q, r in ((0, 8), (31, 8), (8, 0), (8, 33)):
        with pytest.raises(ValueError):
            kfp.fingerprint(keys, q, r)
    with pytest.raises(TypeError):
        kfp.fingerprint(keys.to(torch.int16), 8, 8)
    with pytest.raises(TypeError):
        kfp.fingerprint(keys, 8, 8, dtype=torch.uint32)


def test_fold_bytes_and_bad_slices():
    for data in (b"", b"abc", bytes(range(256))):
        assert tfp.fold_bytes(data, 9) == jfp.fold_bytes(data, 9)
    with pytest.raises(ValueError):
        tfp.extract_bits(torch.zeros(1, dtype=torch.int64), torch.zeros(1), 40, 30)
    with pytest.raises(ValueError):
        tfp.fingerprint(torch.zeros(1), 31, 4)
    assert tfuse.canonical_split(39) == (7, 32)


@functools.lru_cache(maxsize=None)
def _filled(q, r, n, seed=0, max_load=1.0):
    jcfg = jqf.QFConfig(q=q, r=r, max_load=max_load)
    tcfg = tqf.QFConfig(q=q, r=r, max_load=max_load)
    keys = _keys(seed, n)
    js = jqf.insert(jcfg, jqf.empty(jcfg), jnp.asarray(keys))
    ts = tqf.insert(tcfg, tqf.empty(tcfg, "cpu"), _t(keys))
    return jcfg, tcfg, js, ts, keys


# compiled: run eagerly the windowed decode takes seconds op by op
_jax_window_decode = jax.jit(jqf._window_decode, static_argnums=(0, 4))


@pytest.mark.parametrize("q,r,n", [(10, 32, 760), (11, 5, 1500)])
def test_build_extract_lookup_match(q, r, n):
    jcfg, tcfg, js, ts, keys = _filled(q, r, n)
    _same_state(js, ts)
    _same_stream(*jqf.extract(jcfg, js)[:2], *tqf.extract(tcfg, ts)[:2])
    probes = np.concatenate([keys, _keys(q, 2 * n)])
    jq, jr = jqf.fingerprints(jcfg, jnp.asarray(probes))
    tq, tr = tqf.fingerprints(tcfg, _t(probes))
    exact = np.asarray(jqf.lookup_exact(jcfg, js, jq, jr))
    assert exact[:n].all()
    np.testing.assert_array_equal(tqf.lookup_exact(tcfg, ts, tq, tr).numpy(), exact)
    # window 4: most clusters leave the window, so the retry and the
    # exact fallback both run
    for window in (256, 4) if r < 8 else (256,):
        np.testing.assert_array_equal(
            tqf.lookup(tcfg, ts, tq, tr, window).numpy(), exact
        )
        jp, jo = _jax_window_decode(jcfg, js, jq, jr, window)
        tp, to = tqf._window_decode(tcfg, ts, tq, tr, window)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())


def test_overflowing_build_sets_the_flag_like_jax():
    jcfg = jqf.QFConfig(q=6, r=10, slack=4)
    tcfg = tqf.QFConfig(q=6, r=10, slack=4)
    keys = _keys(11, 80)  # more keys than slots
    js = jqf.insert(jcfg, jqf.empty(jcfg), jnp.asarray(keys))
    ts = tqf.insert(tcfg, tqf.empty(tcfg, "cpu"), _t(keys))
    assert bool(ts.overflow)
    _same_state(js, ts)


def test_insert_delete_merge_match():
    jcfg, tcfg, js, ts, keys = _filled(9, 15, 300, seed=2)
    dels = np.concatenate([keys[:250], keys[:40], _keys(9, 10)])
    _same_state(
        jqf.delete(jcfg, js, jnp.asarray(dels)), tqf.delete(tcfg, ts, _t(dels))
    )
    _same_state(
        jqf.insert(jcfg, js, jnp.asarray(keys), 17),
        tqf.insert(tcfg, ts, _t(keys), 17),
    )
    # merges into a wider table (requotient up) are held against the JAX
    # package by the buffered flushes of tests/test_torch_filters.py
    _, ta8, _, tb, _ = _filled(8, 16, 190, seed=4)
    with pytest.raises(ValueError):
        tqf.merge(tqf.QFConfig(q=11, r=12), tcfg, ta8, ts, tb)
    assert bool(tqf.contains_one(tcfg, ts, int(keys[3])))
    one = tqf.delete_one(tcfg, tqf.insert_one(tcfg, ts, 12345), 12345)
    _same_state(js, one)


def test_requotient_and_stream_merges_match():
    jcfg, tcfg, js, ts, keys = _filled(9, 15, 300, seed=2)
    jq, jr, jn = jqf.extract(jcfg, js)
    tq, tr, tn = tqf.extract(tcfg, ts)
    for q in (1, 12):  # requotient down to r = 23, up to r = 12
        jt, tt = jqf.QFConfig(q=q, r=24 - q), tqf.QFConfig(q=q, r=24 - q)
        # padding rows included: they carry the JAX values bit for bit
        _same_stream(
            *jqf._requotient(jq, jr, jcfg, jt), *tqf._requotient(tq, tr, tcfg, tt)
        )
    # a second stream in the same split: the q = 8 filter, requotiented
    j8, t8, jb8, tb8, _ = _filled(8, 16, 190, seed=4)
    jbq, jbr, jbn = jqf.extract(j8, jb8)
    tbq, tbr, tbn = tqf.extract(t8, tb8)
    jb = (*jqf._requotient(jbq, jbr, j8, jcfg), jbn)
    tb = (*tqf._requotient(tbq, tbr, t8, tcfg), tbn)
    a = (jq, jr, jn)
    j_all = jax.jit(jqf.merge_streams_many)([a, jb, a])
    t_all = tqf.merge_streams_many([(tq, tr, tn), tb, (tq, tr, tn)])
    _same_stream(*j_all[:2], *t_all[:2])
    assert int(j_all[2]) == int(t_all[2])
    with pytest.raises(ValueError):
        tqf.merge_streams_many([])


def test_state_on_the_requested_device_and_load():
    tcfg = tqf.QFConfig(q=6, r=10)
    st = tqf.empty(tcfg, "cpu")
    assert {t.device.type for t in st} == {"cpu"}
    assert st.rem.dtype == torch.int32 and st.occ.dtype == torch.bool
    assert float(tqf.load(tcfg, st)) == 0.0
    assert tcfg.size_bytes == jqf.QFConfig(q=6, r=10).size_bytes
