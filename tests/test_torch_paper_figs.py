"""The paper's experiments of ``chip_smoke.py`` phases 15 and 16 against the JAX package.

Each experiment function of the two phases (``ssd_experiment``,
``fprate_experiment``, ``clusters_experiment``, ``occupancy_experiment``,
``fanout_experiment``) runs here on the CPU at its bench's own size or
smaller, with its checks against the plain path, and the same draws go
through the JAX package's ``repro.core`` and ``repro.filters`` directly.
Integer results are exact, and so are the modeled ops/s, which come from
equal ``IOLog``s:

- Figs 1/2 (``bench_fprate``) at q = 14: the fp counts per r and per
  bits/element on the member-free probe set, the JAX side's from its
  fingerprints and Bloom cell indices by set membership;
- Fig 4 (``bench_clusters``) at q = 12: every cluster length;
- Fig 6 (``bench_occupancy``) at q = 12: the fill schedule and the hit
  masks (no times);
- Fig 9 (``bench_fanout``) at RAM_Q = 7: levels, ``IOLog``s, modeled
  ops/s and hits of the ``CascadeFilter`` shims;
- Table 1(b) (``bench_ssd``) at ratio 24 and RAM_Q = 7: the five
  structures' ``IOLog``s, modeled ops/s and hits.

On the CPU the kernel wrappers run their plain versions, and the card's
clock is not read: ``median_ms`` calls its function once and reports 1 ms.
Nearly all the time here is the JAX package compiling each new shape, so
its side of every experiment is computed once, in four chains of jobs
that share compiled code, each in a thread started with the module.
"""
import importlib.util
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.core import bf_variants as jbf
from repro.core import bloom as jbloom
from repro.core import quotient_filter as jqf
from repro.core.cascade_filter import CascadeFilter as JCF
from repro.core.cost_model import PAPER_SSD, modeled_throughput


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_chip_smoke()

FP_Q, FP_PROBES = 14, 1 << 15  # bench_fprate's q, a twelfth of its probes
CLUSTER_Q = 12
OCC_Q, OCC_BATCH, OCC_PROBES = 12, 1 << 9, 1 << 10  # bench_occupancy / 2**4
FANOUT = dict(ram_q=7, p=23, n=5_000, step=64, n_lookups=256)  # bench_fanout / 8
SSD_RATIO, SSD_RAM_Q, SSD_CHECKS = 24, 7, 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are small, and the JAX
    threads would otherwise contend with idle OpenMP workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_clock(monkeypatch):
    """No card: synchronising is a no-op and ``median_ms`` times nothing."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "median_ms", lambda fn, reps=0: (fn(), 1.0)[1])


def _u32(rng, n, lo=0):
    return rng.integers(lo, 2**32, size=n, dtype=np.int64).astype(np.uint32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _io(log) -> dict:
    return {k: v for k, v in vars(log).items() if k != "notes"}


# -- Figs 1/2 ----------------------------------------------------------------


def _jax_fprate(q, n_probes):
    """bench_fprate's fp counts by the JAX package's hashes: a QF answers
    yes exactly when a member has the probe's fingerprint, a Bloom filter
    when every cell of the probe's indices is set by a member.  No filter
    is compiled for it."""
    rng = np.random.default_rng(7)
    n = int((1 << q) * 0.75)
    keys = _u32(rng, n)
    probes = _u32(rng, n_probes, lo=2**31)
    probes = probes[~np.isin(probes, keys)]
    out = {"probes": probes.shape[0], "qf": {}, "bloom": {}}
    for r in (4, 6, 8, 10, 12):
        cfg = jqf.QFConfig(q=q, r=r)

        def fp(ks, cfg=cfg):
            fq, fr = jqf.fingerprints(cfg, jnp.asarray(ks))
            return (np.asarray(fq).astype(np.int64) << r) | np.asarray(fr).astype(np.int64)

        out["qf"][r] = int(np.isin(fp(probes), fp(keys)).sum())
    for bits in (6, 9, 12, 15):
        cfg = jbloom.BloomConfig(m_bits=n * bits, k=jbloom.optimal_k(bits))
        cells = np.zeros(cfg.m_bits, bool)
        cells[np.asarray(jbloom.bit_indices(cfg, jnp.asarray(keys))).ravel()] = True
        idx = np.asarray(jbloom.bit_indices(cfg, jnp.asarray(probes)))
        out["bloom"][bits] = int(cells[idx].all(axis=1).sum())
    return out


def test_fprate_counts_match_jax(jax_side):
    got = cs.fprate_experiment(FP_Q, FP_PROBES, "cpu")
    want = jax_side["fprate"].result()
    assert got["probes"] == want["probes"]  # the same members removed
    for kind in ("qf", "bloom"):
        assert {x: row["false_positives"] for x, row in got[kind].items()} == want[kind]
    n = got["n"]
    assert got["qf"][12]["analytic"] == 1 - math.exp(-n / 2**26)
    # the fp rate falls with the bits an element in both structures
    for kind in ("qf", "bloom"):
        rates = [row["empirical"] for row in got[kind].values()]
        assert rates == sorted(rates, reverse=True)


# -- Fig 4 -------------------------------------------------------------------


def _bench_cluster_lengths(nonempty):
    """bench_clusters' loop, as the bench writes it."""
    changes = np.flatnonzero(np.diff(nonempty.astype(np.int8)))
    edges = np.concatenate([[-1], changes, [len(nonempty) - 1]])
    lengths, state = [], nonempty[0]
    for a, b in zip(edges[:-1], edges[1:]):
        if state:
            lengths.append(b - a)
        state = not state
    return np.asarray(lengths)


def _jax_clusters(q):
    rng = np.random.default_rng(4)
    out = {}
    for alpha in (0.5, 0.75, 0.9):
        cfg, st = jf.make("qf", q=q, r=10, slack=4096, max_load=alpha, backend="pallas")
        st = jf.insert(cfg, st, jnp.asarray(_u32(rng, int((1 << q) * alpha))))
        out[alpha] = _bench_cluster_lengths(np.asarray(st.occ | st.shf))
    return out


def test_cluster_lengths_match_jax(jax_side):
    report, lengths = cs.clusters_experiment(CLUSTER_Q, "cpu")
    for alpha, want in jax_side["clusters"].result().items():
        np.testing.assert_array_equal(lengths[alpha], want, err_msg=str(alpha))
        assert report[alpha]["mean"] == float(want.mean())
        assert report[alpha]["p99"] == float(np.percentile(want, 99))
        assert report[alpha]["mean"] < report[alpha]["analytic_mean_bound"]
    # clusters grow with the load
    assert report[0.5]["mean"] < report[0.75]["mean"] < report[0.9]["mean"]


def test_cluster_lengths_edges():
    runs = torch.tensor([1, 1, 0, 1, 0, 0, 1, 1, 1], dtype=torch.bool)
    np.testing.assert_array_equal(cs.cluster_lengths(runs).numpy(), [2, 1, 3])
    np.testing.assert_array_equal(
        cs.cluster_lengths(~runs).numpy(), _bench_cluster_lengths((~runs).numpy())
    )


# -- Fig 6 -------------------------------------------------------------------


def _jax_occupancy(q, batch_size, n_probes):
    rng = np.random.default_rng(5)
    cfg, st = jf.make("qf", q=q, r=10, slack=4096, max_load=0.95, backend="pallas")
    m_bits = int((1 << q) * 0.95 * 9 / np.log(2))
    bcfg, bits = jf.make("bloom", m_bits=m_bits, k=9, backend="pallas")
    probes = jnp.asarray(_u32(rng, n_probes, lo=2**31))
    schedule, hits = [], {}
    for pct in (30, 60, 90):
        target = int((1 << q) * pct / 100)
        while int(st.n) < target:
            batch = jnp.asarray(_u32(rng, min(batch_size, target - int(st.n))))
            st = jf.insert(cfg, st, batch)
            bits = jf.insert(bcfg, bits, batch)
            schedule.append(batch.shape[0])
        hits[pct] = (_np(jf.contains(cfg, st, probes)), _np(jf.contains(bcfg, bits, probes)))
    return schedule, hits


def test_occupancy_schedule_and_hits_match_jax(jax_side):
    report, schedule, hits = cs.occupancy_experiment(OCC_Q, OCC_BATCH, OCC_PROBES, "cpu")
    want_schedule, want_hits = jax_side["occupancy"].result()
    for pct, (qf_hit, bf_hit) in want_hits.items():
        np.testing.assert_array_equal(_np(hits[pct][0]), qf_hit, err_msg=str(pct))
        np.testing.assert_array_equal(_np(hits[pct][1]), bf_hit, err_msg=str(pct))
    assert schedule == want_schedule
    assert sorted(k for k in report if isinstance(k, int)) == [30, 60, 90]


# -- Fig 9 -------------------------------------------------------------------


def _jax_fanout(fanout, ram_q, p, n, step, n_lookups):
    rng = np.random.default_rng(9)
    cf = JCF(ram_q=ram_q, p=p, fanout=fanout)
    keys = jnp.asarray(_u32(rng, n))
    for i in range(0, n, step):
        cf.insert(keys[i : i + step])
    ingest = cf.io.snapshot()
    hit = cf.lookup(jnp.asarray(_u32(rng, n_lookups, lo=2**31)))
    levels = [c.q for c, s in cf.levels if int(s.n) > 0]
    return levels, ingest, cf.io.delta(ingest), _np(hit)


def test_fanout_tradeoff_matches_jax(jax_side):
    f = FANOUT
    report, logs, hits = cs.fanout_experiment(
        f["ram_q"], f["p"], f["n"], f["step"], f["n_lookups"], 512, "cpu"
    )
    for fanout in (2, 4, 16):
        level_qs, ingest, lookup, hit = jax_side[("fanout", fanout)].result()
        assert _io(logs[fanout][0]) == _io(ingest), fanout
        assert _io(logs[fanout][1]) == _io(lookup), fanout
        np.testing.assert_array_equal(_np(hits[fanout]), _np(hit))
        row = report[fanout]
        assert row["levels"] == len(level_qs)
        assert row["level_qs"] == level_qs
        assert row["insert_ops_per_s"] == modeled_throughput(f["n"], ingest, PAPER_SSD)
        assert row["lookup_ops_per_s"] == modeled_throughput(
            f["n_lookups"], lookup, PAPER_SSD
        )
    assert report[16]["levels"] < report[2]["levels"]


# -- Table 1(b) at 1:24 ------------------------------------------------------


class _JaxFunctional:
    """bench_ssd's ``_Functional`` over ``repro.filters``."""

    def __init__(self, name, **spec):
        self.cfg, self.state = jf.make(name, **spec)
        self._insert = jax.jit(lambda s, ks: jf.insert(self.cfg, s, ks))
        self._probe = jax.jit(lambda s, ks: jf.probe(self.cfg, s, ks))

    def insert(self, keys):
        self.state = self._insert(self.state, keys)

    def lookup(self, keys):
        self.state, hit = self._probe(self.state, keys)
        return hit

    @property
    def io(self):
        return jf.to_iolog(self.state.io)


def _jax_ssd_makers(ratio, ram_q, n_total):
    """bench_ssd's ``_mk_structs`` at ``ram_q`` over the JAX package."""
    p = ram_q + 15
    disk_q = ram_q + max(2, int(np.ceil(np.log2(ratio * 1.8))))
    k = 12
    m_bits = int(n_total * k / np.log(2))
    ram_bits = m_bits // ratio
    bcfg = jbloom.BloomConfig(m_bits=m_bits, k=k)
    return {
        "cf": lambda: _JaxFunctional("cascade", ram_q=ram_q, p=p, fanout=2, levels=6,
                                     backend="pallas"),
        "bqf": lambda: _JaxFunctional("buffered_qf", ram_q=ram_q, disk_q=disk_q, p=p,
                                      backend="pallas"),
        "ebf": lambda: jbf.ElevatorBloomFilter(bcfg, buffer_capacity_bits=ram_bits // 64),
        "bbf": lambda: jbf.BufferedBloomFilter(bcfg, ram_bytes=ram_bits // 8,
                                               block_bytes=4096 * 8, page_bytes=512),
        "fbf": lambda: jbf.ForestBloomFilter(bits_per_element=k / np.log(2),
                                             ram_bytes=ram_bits // 8,
                                             total_elements=n_total),
    }


def _jax_ssd_draws(ratio, ram_q):
    """bench_ssd's draws: the keys and its two lookup sets."""
    rng = np.random.default_rng(ratio)
    n_total = ratio * jqf.QFConfig(q=ram_q, r=1).capacity
    keys = _u32(rng, n_total)
    pick = rng.integers(0, n_total, 2048)
    lookups = (jnp.asarray(_u32(rng, 2048, lo=2**31)), jnp.asarray(keys[pick]))
    return jnp.asarray(keys), lookups


def _jax_ssd(name, ratio, ram_q):
    """One structure through bench_ssd's ingest and lookups: its three logs
    and the two lookups' hits."""
    keys, lookups = _jax_ssd_draws(ratio, ram_q)
    s = _jax_ssd_makers(ratio, ram_q, keys.shape[0])[name]()
    step = max(256, keys.shape[0] // 64)
    for i in range(0, keys.shape[0], step):
        s.insert(keys[i : i + step])
    ingest = s.io.snapshot()
    uniform_hit = s.lookup(lookups[0])
    mid = s.io.snapshot()
    hit = s.lookup(lookups[1])
    logs = (ingest, mid.delta(ingest), s.io.snapshot().delta(mid))
    return logs, (_np(uniform_hit), _np(hit))


def test_table_1b_at_1_to_24_matches_jax(jax_side):
    report, logs, hits = cs.ssd_experiment(SSD_RATIO, SSD_RAM_Q, SSD_CHECKS, "cpu")
    n_total = SSD_RATIO * jqf.QFConfig(q=SSD_RAM_Q, r=1).capacity
    want = {n: jax_side[("ssd", n)].result() for n in ("cf", "bqf", "ebf", "bbf", "fbf")}
    assert report["keys"] == n_total and report["batch"] == 256
    assert set(logs) == set(want) == {"cf", "bqf", "ebf", "bbf", "fbf"}
    for name, (want_logs, want_hits) in want.items():
        assert [_io(x) for x in logs[name]] == [_io(x) for x in want_logs], name
        for got_hit, want_hit in zip(hits[name], want_hits):
            np.testing.assert_array_equal(_np(got_hit), _np(want_hit), err_msg=name)
        assert report["modeled_ops_per_s"][name] == {
            "insert": modeled_throughput(n_total, want_logs[0], PAPER_SSD),
            "lookup_uniform": modeled_throughput(2048, want_logs[1], PAPER_SSD),
            "lookup_hit": modeled_throughput(2048, want_logs[2], PAPER_SSD),
        }
    ins = {n: m["insert"] for n, m in report["modeled_ops_per_s"].items()}
    assert report["cf_over_bqf"] == ins["cf"] / ins["bqf"]
    best = max(ins[b] for b in ("ebf", "bbf", "fbf"))
    assert report["vs_best_bf"]["with_fbf"]["cf"] == ins["cf"] / best
    assert report["best_bf"]["without_fbf"] in ("ebf", "bbf")
    for name in ("cf", "bqf"):
        check = report["checks"][name]
        assert check["fp_rate"] <= 2 * check["union_bound"]


def _jax_chain(jobs: dict) -> dict:
    """Run ``jobs`` (name: (function, *args)) one after another, so that
    each reuses the code the ones before it compiled."""
    return {name: fn(*args) for name, (fn, *args) in jobs.items()}


class _Pick:
    """One job's result out of a chain's future."""

    def __init__(self, future, name):
        self.future, self.name = future, name

    def result(self):
        return self.future.result()[self.name]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's side of every experiment, in four chains of jobs
    that share compiled code, each chain in a thread of its own."""
    f = FANOUT
    fanout = (f["ram_q"], f["p"], f["n"], f["step"], f["n_lookups"])
    ssd = lambda n: (_jax_ssd, n, SSD_RATIO, SSD_RAM_Q)
    chains = [
        {("fanout", x): (_jax_fanout, x, *fanout) for x in (2, 4, 16)},
        {("ssd", n): ssd(n) for n in ("cf", "bqf", "ebf", "bbf")},
        {"fprate": (_jax_fprate, FP_Q, FP_PROBES), ("ssd", "fbf"): ssd("fbf")},
        {
            "clusters": (_jax_clusters, CLUSTER_Q),
            "occupancy": (_jax_occupancy, OCC_Q, OCC_BATCH, OCC_PROBES),
        },
    ]
    with ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futures = [(pool.submit(_jax_chain, chain), chain) for chain in chains]
        yield {name: _Pick(fut, name) for fut, chain in futures for name in chain}
