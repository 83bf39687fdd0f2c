"""The plain reference against the port's ``"reference"`` backend (and the
kernel path's plain versions) on the CPU, at q <= 12, for both families."""

import pytest
import torch

from amqbench.reference import cascade as ref_cascade
from amqbench.reference import qf as ref_qf
from amqbench.reference.fingerprint import fingerprints
from repro_torch import filters
from repro_torch.core.fingerprint import fingerprint as port_fingerprint


def keys(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(2**31), 2**31, (n,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("q,r,seed",
                         [(10, 8, 0), (12, 12, 0), (20, 20, 3), (28, 12, 0), (5, 27, 7)])
def test_fingerprint_is_the_ports(q, r, seed):
    k = keys(4096, q + r)
    fq, fr = port_fingerprint(k, q, r, seed)
    assert torch.equal(fingerprints(k, q + r, seed), (fq << r) | fr)


def _same(port_state, model):
    numbers = ref_qf.compare(ref_qf.read_state(port_state), model.structures())
    assert numbers == {"plane_mismatches": 0, "count_gap": 0, "overflow_flags": 0}


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("q,r,slack", [(10, 8, 64), (12, 12, 1024), (8, 20, 16)])
def test_qf_planes_equal_the_ports(backend, q, r, slack):
    spec = {"q": q, "r": r, "slack": slack, "seed": 0, "max_load": 0.75}
    cfg, st = filters.make("qf", device="cpu", backend=backend, **spec)
    m = ref_qf.Model(spec, "cpu")
    n = int(0.7 * (1 << q))
    for i, b in enumerate(keys(n, q * r).split(max(1, n // 5))):
        st = filters.insert(cfg, st, b)
        m.insert(b)
        _same(st, m)
    probes = torch.cat([keys(500, 99), m.batches[0][:200]])
    assert torch.equal(filters.contains(cfg, st, probes), m.contains(probes))


def test_qf_overflow_is_reported_as_the_port_reports_it():
    spec = {"q": 6, "r": 8, "slack": 2, "seed": 0, "max_load": 0.75}
    cfg, st = filters.make("qf", device="cpu", **spec)
    m = ref_qf.Model(spec, "cpu")
    b = keys(80, 5)
    st = filters.insert(cfg, st, b)
    m.insert(b)
    assert bool(st.overflow) and bool(m.structures()[0]["overflow"])


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("ram_q,p,levels,batch", [(6, 20, 3, 18), (5, 24, 4, 7), (8, 30, 2, 100)])
def test_cascade_structures_equal_the_ports_after_every_batch(backend, ram_q, p, levels, batch):
    spec = {"ram_q": ram_q, "p": p, "fanout": 2, "levels": levels, "seed": 0, "max_load": 0.75}
    cfg, st = filters.make("cascade", device="cpu", backend=backend, **spec)
    m = ref_cascade.Model(spec, "cpu")
    cap = sum(m.caps) + int((1 << ram_q) * 0.75)
    for i in range(int(0.9 * cap) // batch):
        b = keys(batch, 1000 + i)
        st = filters.insert(cfg, st, b)
        m.insert(b)
        _same(st, m)
    probes = torch.cat([keys(700, 7), torch.cat(m.batches)[:300]])
    assert torch.equal(filters.contains(cfg, st, probes), m.contains(probes))


def test_cascade_schedule_of_the_1_to_24_set():
    """The collapse targets of bench_ssd's 64 batches at RAM_Q = 23."""
    spec = {"ram_q": 23, "p": 38, "fanout": 2, "levels": 5, "max_load": 0.75}
    m = ref_cascade.Model(spec, "meta")
    for _ in range(64):
        m.insert(torch.empty(2359296, device="meta"))
    assert m.counts == [2359296, 7077888, 0, 28311552, 0, 113246208]


def test_lower_precision_changes_the_planes_not_the_shapes():
    spec = {"q": 10, "r": 8, "slack": 64, "seed": 0}
    a, b = ref_qf.Model(spec, "cpu"), ref_qf.Model(spec, "cpu", drop=1)
    k = keys(700, 1)
    a.insert(k)
    b.insert(k)
    sa, sb = a.structures()[0], b.structures()[0]
    assert sa["rem"].shape == sb["rem"].shape
    assert not torch.equal(sa["rem"], sb["rem"])


def test_visits_stop_at_the_first_structure_that_holds_the_key():
    spec = {"ram_q": 6, "p": 20, "fanout": 2, "levels": 3, "seed": 0, "max_load": 0.75}
    m = ref_cascade.Model(spec, "cpu")
    for i in range(20):
        m.insert(keys(18, 500 + i))
    live = [h.shape[0] > 0 for h in m.held()]
    assert sum(live) >= 2
    fresh, first = keys(50, 9), m.batches[0][:10]
    assert torch.equal(m.visits(fresh), torch.full((50,), sum(live)))
    top = next(i for i, h in enumerate(m.held_by) if 0 in h)
    assert torch.equal(m.visits(first), torch.full((10,), sum(live[: top + 1])))


@pytest.mark.parametrize("name,capacity", [("qf", 768), ("cascade", 48 + 96 + 192 + 384)])
def test_capacity_counts_every_structure(name, capacity):
    spec = {"q": 10, "r": 8, "slack": 64, "ram_q": 6, "p": 20, "fanout": 2, "levels": 3,
            "max_load": 0.75}
    model = {"qf": ref_qf.Model, "cascade": ref_cascade.Model}[name]
    assert model(spec, "meta").capacity() == capacity
