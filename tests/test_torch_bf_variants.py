"""The port's SSD Bloom baselines (EBF, BBF, FBF) against the JAX package's.

``benchmarks/bench_ssd.py`` builds the three at its own scale (RAM QF
q = 11, ratio 4: 6,144 keys) and turns their ``IOLog`` into the paper's
modeled throughput.  Here the same keys, in 64 batches, go through
``repro.core.bf_variants`` and ``repro_torch.core.bf_variants`` (state on
the CPU); every ``IOLog`` field must be equal after the ingest and after
each lookup set, and so must the hit masks.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bf_variants as jbf
from repro.core import bloom as jbloom
from repro_torch.core import bf_variants as tbf
from repro_torch.core import bloom as tbloom

RAM_Q, RATIO, BATCHES = 11, 4, 64
N_TOTAL = RATIO * int((1 << RAM_Q) * 0.75)  # 6,144 keys
K = 12
M_BITS = int(N_TOTAL * K / np.log(2))
RAM_BITS = M_BITS // RATIO


def _structs(bf, bloom, **device):
    """bench_ssd's ``_mk_structs`` baselines, built from package ``bf``."""
    return {
        "ebf": lambda: bf.ElevatorBloomFilter(
            bloom.BloomConfig(m_bits=M_BITS, k=K),
            buffer_capacity_bits=RAM_BITS // 64,
            **device,
        ),
        "bbf": lambda: bf.BufferedBloomFilter(
            bloom.BloomConfig(m_bits=M_BITS, k=K),
            ram_bytes=RAM_BITS // 8,
            block_bytes=4096 * 8,
            page_bytes=512,
            **device,
        ),
        "fbf": lambda: bf.ForestBloomFilter(
            bits_per_element=K / np.log(2),
            ram_bytes=RAM_BITS // 8,
            total_elements=N_TOTAL,
            **device,
        ),
    }


def _key_sets():
    rng = np.random.default_rng(RATIO)  # bench_ssd seeds with the ratio
    keys = rng.integers(0, 2**32, size=N_TOTAL, dtype=np.int64).astype(np.uint32)
    uniform = rng.integers(2**31, 2**32, size=2048, dtype=np.int64).astype(np.uint32)
    hits = keys[rng.integers(0, N_TOTAL, 2048)]
    return keys, uniform, hits


def _run(struct, keys, to_keys):
    """Ingest, then the uniform and the hit lookups; every log and mask seen."""
    keys, uniform, hits = keys
    seen = []
    step = N_TOTAL // BATCHES
    for i in range(0, N_TOTAL, step):
        struct.insert(to_keys(keys[i : i + step]))
    seen.append(("ingest", dict(vars(struct.io))))
    for label, probes in (("uniform", uniform), ("hits", hits)):
        hit = struct.lookup(to_keys(probes))
        seen.append((label, dict(vars(struct.io)), np.asarray(hit).astype(bool)))
    return seen


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return _run(_structs(jbf, jbloom)[name](), _key_sets(), jnp.asarray)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


@pytest.mark.parametrize("name", ["ebf", "bbf", "fbf"])
def test_iolog_and_hits_match_jax(name):
    struct = _structs(tbf, tbloom, device="cpu")[name]()
    got = _run(struct, _key_sets(), _tkeys)
    want = _jax_run(name)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert g[1] == w[1], g[0]
        if len(g) > 2:
            np.testing.assert_array_equal(g[2], w[2], err_msg=g[0])
    assert got[-1][2].all()  # inserted keys: no false negative
    assert got[0][1]["rand_page_writes"] > 0 and got[1][1]["rand_page_reads"] > 0


def test_fbf_layers_match_jax():
    """The forest's sealed layers: the same seeds, in order, and the same bits."""
    keys = _key_sets()[0]
    step = N_TOTAL // BATCHES
    jfbf = _structs(jbf, jbloom)["fbf"]()
    tfbf = _structs(tbf, tbloom, device="cpu")["fbf"]()
    for i in range(0, N_TOTAL, step):
        jfbf.insert(jnp.asarray(keys[i : i + step]))
        tfbf.insert(_tkeys(keys[i : i + step]))
    assert len(tfbf.layers) >= 3
    assert [c for c, _ in tfbf.layers] == [tuple(c) for c, _ in jfbf.layers]
    for (_, t), (_, j) in zip(tfbf.layers, jfbf.layers):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ram = tfbf.ram_bits_arr.numpy()
    np.testing.assert_array_equal(ram, np.asarray(jfbf.ram_bits_arr))


def test_unique_prefix_pages_matches_jax():
    rng = np.random.default_rng(3)
    pages = rng.integers(0, 5, (300, 8))
    prefix = rng.integers(0, 9, 300)
    want = jbf._unique_prefix_pages(pages, prefix)
    got = tbf._unique_prefix_pages(torch.from_numpy(pages), torch.from_numpy(prefix))
    assert got == want
