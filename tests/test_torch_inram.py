"""Table 1(a)'s structures in the port against the JAX package's, bit for bit.

``benchmarks/bench_inram.py`` compares an in-RAM ``qf`` with a ``bloom``
filter at the paper's three fp rates (1/64, 1/512, 1/4096: r = 6, 9, 12
and k = 6, 9, 12, m = n k / ln 2), both filled to 75% of 2**q.  Here at
q = 10, with the bench's draws (``default_rng(0)``: the fill, an insert
batch, uniform lookups from [2**31, 2**32)) and its batch sizes scaled
by the same 2**-8 as q: the three QF states and the three Bloom states
after the fill and after one more insert batch, and the hits of the
uniform and the successful lookups, equal to the JAX package's under
both of the port's backend spellings.  ``chip_smoke.py``'s phase
"inram" runs the same experiment on the card at q = 26.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro_torch import filters as tf

CASES = [(1 / 64, 6), (1 / 512, 9), (1 / 4096, 12)]  # bench_inram's
Q = 10
LOAD = 0.75
INSERT_BATCH = 1 << 6  # bench_inram's 2**14 at q = 18, scaled with q
LOOKUP_BATCH = 1 << 8  # its 2**16


def _u32(rng, n, lo=0, hi=2**32):
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _leaves(f, cfg, state):
    if f is jf:
        return [np.array(x) for x in jax.tree_util.tree_leaves(state)]
    return tf.to_numpy(cfg, state)


def _experiment(f, keys_of, make):
    """bench_inram's draws and structures; every state and hit mask."""
    rng = np.random.default_rng(0)
    n = int((1 << Q) * LOAD)
    out = {}
    for fp, r in CASES:
        cfg, st = make("qf", q=Q, r=r, slack=2048)
        keys = _u32(rng, n)
        st = f.insert(cfg, st, keys_of(keys))
        k = max(1, round(-np.log2(fp)))
        bcfg, bits = make("bloom", m_bits=int(n * k / np.log(2)), k=k)
        bits = f.insert(bcfg, bits, keys_of(keys))
        batch = keys_of(_u32(rng, INSERT_BATCH))
        probes = keys_of(_u32(rng, LOOKUP_BATCH, lo=2**31))
        hits = keys_of(keys[:LOOKUP_BATCH])
        for name, c, s in (("qf", cfg, st), ("bloom", bcfg, bits)):
            out[(r, name, "filled")] = _leaves(f, c, s)
            out[(r, name, "batch")] = _leaves(f, c, f.insert(c, s, batch))
            out[(r, name, "uniform")] = np.asarray(f.contains(c, s, probes))
            out[(r, name, "successful")] = np.asarray(f.contains(c, s, hits))
            out[(r, name, "stats")] = {
                key: np.asarray(v) for key, v in f.stats(c, s).items()
            }
    return out


@functools.lru_cache(maxsize=None)
def _jax_experiment():
    make = lambda name, **s: jf.make(name, **dict(s, backend="pallas"))
    return _experiment(jf, jnp.asarray, make)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_table_1a_structures_match_jax(backend):
    want = _jax_experiment()
    make = lambda name, **s: tf.make(name, device="cpu", **dict(s, backend=backend))
    got = _experiment(tf, _tkeys, make)
    assert got.keys() == want.keys()
    for what, t in got.items():
        j = want[what]
        if what[2] == "stats":
            for key, v in t.items():
                np.testing.assert_array_equal(j[key], v, err_msg=f"{what} {key}")
        elif isinstance(t, list):
            assert len(t) == len(j), what
            for a, b in zip(j, t):
                assert a.dtype == b.dtype, what
                np.testing.assert_array_equal(a, b, err_msg=str(what))
        else:
            np.testing.assert_array_equal(t, j, err_msg=str(what))
    n = int((1 << Q) * LOAD)
    for _, r in CASES:
        for name in ("qf", "bloom"):
            assert got[(r, name, "successful")].all()  # no false negative
        assert not got[(r, "qf", "stats")]["overflow"]
        assert int(got[(r, "qf", "stats")]["n"]) == n
    # the fp rate falls with r (k) in both structures
    for name in ("qf", "bloom"):
        fps = [got[(r, name, "uniform")].mean() for _, r in CASES]
        assert fps[0] > fps[2]
