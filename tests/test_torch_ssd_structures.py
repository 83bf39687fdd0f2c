"""The port's host-driven shims against the JAX package's, bit for bit.

``repro_torch.core.BufferedQuotientFilter`` and ``CascadeFilter`` port
``repro.core.buffered_qf`` and ``repro.core.cascade_filter``.  Each case
of ``tests/test_ssd_structures.py::TestBQF`` and ``::TestCascade`` runs
here on both packages with the same numpy keys (``default_rng(42)``, as
its fixture draws them), and every observation must be equal: ``count``,
``n_nonempty_levels``, every ``IOLog`` field (after every batch under
``deamortize=True``), the RAM and disk planes or the Q0 and level planes,
and the hit masks.  The reference's own assertions are checked on the
port's side too.

On the CPU the shims take the plain path (``backend="reference"``); the
``"pallas"`` case swaps in the kernel path, whose wrappers run their
plain versions here, as the shims take it on the card.  The JAX side
runs each case once per module, in three threads started with the
module: nearly all its time is compiling each new shape, so the cases
that share shapes run one after another in one thread.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core
from repro.core import quotient_filter as jqf
from repro.core.buffered_qf import BufferedQuotientFilter as JBQF
from repro.core.cascade_filter import CascadeFilter as JCF
from repro_torch.core import quotient_filter as tqf
from repro_torch.core.buffered_qf import BufferedQuotientFilter as TBQF
from repro_torch.core.cascade_filter import CascadeFilter as TCF
from repro_torch.kernels import dispatch


def _draw(rng, n, lo=0, hi=2**31):
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.uint32)


class _Jax:
    bqf = staticmethod(lambda ram, disk: JBQF(jqf.QFConfig(**ram), jqf.QFConfig(**disk)))
    cf = staticmethod(lambda **kw: JCF(**kw))
    keys = staticmethod(jnp.asarray)


class _Port:
    bqf = staticmethod(
        lambda ram, disk: TBQF(tqf.QFConfig(**ram), tqf.QFConfig(**disk), device="cpu")
    )
    cf = staticmethod(lambda **kw: TCF(device="cpu", **kw))
    keys = staticmethod(lambda k: torch.from_numpy(k.view(np.int32).copy()))


def _planes(state) -> list:
    """A QF state's fields as numpy, ``rem`` as uint32 bit patterns."""
    out = []
    for x in state:
        a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out.append(a.view(np.uint32) if a.dtype == np.int32 and a.ndim else a)
    return out


def _io(s) -> dict:
    return {k: v for k, v in vars(s.io).items() if k != "notes"}


def _bqf_obs(s, hit=None) -> dict:
    obs = {"count": s.count, "io": _io(s), "ram": _planes(s.ram),
           "disk": _planes(s.disk)}
    if hit is not None:
        obs["hit"] = np.asarray(hit)
    return obs


def _cf_obs(s, hit=None) -> dict:
    obs = {
        "count": s.count,
        "levels": s.n_nonempty_levels(),
        "io": _io(s),
        "size_bytes": s.size_bytes,
        "q0": _planes(s.q0),
        "planes": [_planes(st) for _, st in s.levels],
        "cfgs": [tuple(c) for c, _ in s.levels],
    }
    if hit is not None:
        obs["hit"] = np.asarray(hit)
    return obs


RAM, DISK = dict(q=9, r=15), dict(q=13, r=11)


def bqf_membership_and_flushes(pkg):
    rng = np.random.default_rng(42)
    bqf = pkg.bqf(RAM, DISK)
    ks = _draw(rng, 5000)
    for i in range(0, 5000, 250):
        bqf.insert(pkg.keys(ks[i : i + 250]))
    return [_bqf_obs(bqf, bqf.lookup(pkg.keys(ks)))]


def bqf_lookup_io_short_circuits(pkg):
    rng = np.random.default_rng(42)
    bqf = pkg.bqf(RAM, DISK)
    ks = _draw(rng, 1000)
    bqf.insert(pkg.keys(ks))
    bqf.flush()
    before = _bqf_obs(bqf)
    return [before, _bqf_obs(bqf, bqf.lookup(pkg.keys(ks[:100])))]


def bqf_flush_cost_is_sequential(pkg):
    rng = np.random.default_rng(42)
    bqf = pkg.bqf(RAM, DISK)
    bqf.insert(pkg.keys(_draw(rng, 300)))
    bqf.flush()
    return [_bqf_obs(bqf)]


def cf_membership_across_merges(pkg):
    rng = np.random.default_rng(42)
    cf = pkg.cf(ram_q=8, p=26, fanout=2)
    ks = _draw(rng, 4000)
    for i in range(0, 4000, 200):
        cf.insert(pkg.keys(ks[i : i + 200]))
    return [_cf_obs(cf, cf.lookup(pkg.keys(ks)))]


def cf_fp_rate(pkg):
    """The reference's 4,000 keys, and 20,000 of its 100,000 probes, in
    the batches of ``cf_membership_across_merges`` (200 keys, 4,000
    probes) so that the JAX side compiles no new shape; a lookup's
    charges and hits add up over the chunks."""
    rng = np.random.default_rng(42)
    cf = pkg.cf(ram_q=8, p=26, fanout=2)
    for _ in range(20):
        cf.insert(pkg.keys(_draw(rng, 200)))
    probes = _draw(rng, 20_000, lo=2**31, hi=2**32)
    hit = np.concatenate(
        [np.asarray(cf.lookup(pkg.keys(probes[i : i + 4000]))) for i in range(0, 20_000, 4000)]
    )
    return [_cf_obs(cf, hit)]


def cf_fanout_level_count(pkg, fanout):
    rng = np.random.default_rng(42)
    cf = pkg.cf(ram_q=8, p=26, fanout=fanout)
    for _ in range(0, 6000, 200):
        cf.insert(pkg.keys(_draw(rng, 200)))
    return [_cf_obs(cf)]


def cf_insert_io_beats_bqf_at_scale(pkg):
    ram_q, p, n = 7, 26, 12_000
    cf = pkg.cf(ram_q=ram_q, p=p, fanout=2)
    bqf = pkg.bqf(dict(q=ram_q, r=p - ram_q), dict(q=14, r=p - 14))
    rng2 = np.random.default_rng(7)
    for _ in range(0, n, 96):
        batch = pkg.keys(_draw(rng2, 96))
        cf.insert(batch)
        bqf.insert(batch)
    return [_cf_obs(cf), _bqf_obs(bqf)]


def cf_deamortized_accounting_smooth(pkg):
    rng = np.random.default_rng(42)
    cf = pkg.cf(ram_q=8, p=26, fanout=2, deamortize=True)
    out = []
    for _ in range(0, 3000, 100):
        cf.insert(pkg.keys(_draw(rng, 100)))
        out.append({"io": _io(cf), "pending": cf._pending_io})
    return out + [_cf_obs(cf)]


CASES = {
    "bqf_membership_and_flushes": bqf_membership_and_flushes,
    "bqf_lookup_io_short_circuits": bqf_lookup_io_short_circuits,
    "bqf_flush_cost_is_sequential": bqf_flush_cost_is_sequential,
    "cf_membership_across_merges": cf_membership_across_merges,
    "cf_fp_rate": cf_fp_rate,
    "cf_fanout_level_count[2]": lambda pkg: cf_fanout_level_count(pkg, 2),
    "cf_fanout_level_count[4]": lambda pkg: cf_fanout_level_count(pkg, 4),
    "cf_fanout_level_count[16]": lambda pkg: cf_fanout_level_count(pkg, 16),
    "cf_insert_io_beats_bqf_at_scale": cf_insert_io_beats_bqf_at_scale,
    "cf_deamortized_accounting_smooth": cf_deamortized_accounting_smooth,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are small, and the JAX
    threads would otherwise contend with idle OpenMP workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_chain(names) -> dict:
    """The JAX observations of ``names``, one case after another, so that
    each reuses the code the ones before it compiled."""
    return {name: CASES[name](_Jax) for name in names}


class _Pick:
    """One case's result out of a chain's future."""

    def __init__(self, future, name):
        self.future, self.name = future, name

    def result(self):
        return self.future.result()[self.name]


@pytest.fixture(scope="module")
def jax_cases():
    """Every case's JAX observations, in three chains of cases that share
    their filters' shapes, each in a thread of its own."""
    chains = [
        [n for n in CASES if n.startswith("bqf")],
        [n for n in CASES if n.startswith("cf") and "at_scale" not in n],
        ["cf_insert_io_beats_bqf_at_scale"],
    ]
    with ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futures = [(pool.submit(_jax_chain, chain), chain) for chain in chains]
        yield {name: _Pick(fut, name) for fut, chain in futures for name in chain}


@pytest.fixture(params=["reference", "pallas"])
def backend(request, monkeypatch):
    """The path the port's shims take: the CPU's own, or the card's kernel
    path, whose wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(dispatch, "backend_for", lambda device: request.param)
    return request.param


def _assert_equal(want, got, where=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), where
        for k in want:
            _assert_equal(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype, (where, want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got, err_msg=where)
    else:
        assert want == got, (where, want, got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_shim_matches_jax(name, backend, jax_cases):
    got = CASES[name](_Port)
    _assert_equal(jax_cases[name].result(), got, name)
    # the reference test's own claims, on the port's side
    last = got[-1]
    if name == "bqf_membership_and_flushes":
        assert last["count"] == 5000 and last["io"]["flushes"] >= 10
        assert last["hit"].all()
    elif name == "bqf_lookup_io_short_circuits":
        reads = last["io"]["rand_page_reads"] - got[0]["io"]["rand_page_reads"]
        assert reads == 100
    elif name == "bqf_flush_cost_is_sequential":
        assert last["io"]["seq_write_bytes"] == tqf.QFConfig(**DISK).size_bytes
        assert last["io"]["rand_page_writes"] == 0
    elif name == "cf_membership_across_merges":
        assert last["count"] == 4000 and last["io"]["merges"] > 0
        assert last["hit"].all()
    elif name == "cf_fp_rate":
        assert last["hit"].mean() < 8 * 4000 / 2**26 + 1e-4
    elif name.startswith("cf_fanout_level_count"):
        fanout = int(name.split("[")[1].rstrip("]"))
        cap = tqf.QFConfig(q=8, r=18).capacity
        assert last["levels"] <= math.ceil(math.log(6000 / cap, fanout)) + 1
    elif name == "cf_insert_io_beats_bqf_at_scale":
        cf_io, bqf_io = got[0]["io"], got[1]["io"]
        cf_bytes = cf_io["seq_read_bytes"] + cf_io["seq_write_bytes"]
        assert cf_bytes < bqf_io["seq_read_bytes"] + bqf_io["seq_write_bytes"]
    elif name == "cf_deamortized_accounting_smooth":
        assert last["io"]["merges"] > 0
        assert any(o["pending"] > 0 for o in got[:-1])


def test_bqf_refuses_unequal_widths_and_seeds():
    for pkg_cfg, make in (
        (jqf.QFConfig, lambda a, b: JBQF(a, b)),
        (tqf.QFConfig, lambda a, b: TBQF(a, b, device="cpu")),
    ):
        with pytest.raises(ValueError, match="fingerprint width"):
            make(pkg_cfg(q=9, r=15), pkg_cfg(q=13, r=12))
        with pytest.raises(ValueError, match="hash seed"):
            make(pkg_cfg(q=9, r=15, seed=1), pkg_cfg(q=13, r=11, seed=2))


def test_cascade_refuses_a_fanout_that_is_not_a_power_of_two():
    for make in (JCF, lambda **kw: TCF(device="cpu", **kw)):
        with pytest.raises(ValueError, match="power of two"):
            make(ram_q=8, p=26, fanout=3)
    assert repro_torch.core.CascadeFilter is TCF
