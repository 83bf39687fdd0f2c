"""The metric arithmetic: byte and sector counts, the percentile over all
calls, a configuration's design capacity, the idle share from a trace,
and every reader on a run made up here."""

import importlib.util
import json

import pytest
import torch

from amqbench.harness import check, metrics, spec, window
from amqbench.harness.metrics import Run, reader
from amqbench.harness.trace import read_events
from amqbench.harness.window import Call, Record

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def test_percentile_is_over_every_call_by_nearest_rank():
    nearest = metrics.module("insert_p95_ms").nearest_rank
    assert nearest(range(1, 101), 0.95) == 95
    assert nearest([3.0], 0.95) == 3.0
    assert nearest([5, 1, 4, 2, 3], 0.95) == 5
    assert nearest(list(range(20)), 0.95) == 18


def test_least_bytes():
    assert metrics.module("insert_roofline").least_bytes(10) == 680
    assert metrics.module("probe_roofline").least_bytes(10, 25) == 50 + 800


@pytest.mark.parametrize("name,capacity", [("qf-r12-q29", 402653184),
                                           ("cascade-f2-1to24", 396361728)])
def test_design_capacity(name, capacity):
    config = spec.load_config(spec.BENCH / "configs" / f"{name}.json")
    assert spec.design_capacity(config) == capacity == config["design_capacity_keys"]


def test_a_wrong_stated_capacity_is_refused(tmp_path):
    config = json.loads((spec.BENCH / "configs" / "qf-r12-q29.json").read_text())
    config["design_capacity_keys"] += 1
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError):
        spec.load_config(path)


class Ev:
    def __init__(self, name, dev, start, end, corr=0, linked=0):
        self.v = (name, dev, start, end, corr, linked)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def end_ns(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def linked_correlation_id(self):
        return self.v[5]


def made_up_trace():
    """A 1000 ns window: an insert span issues two kernels, a restore
    span one copy; the card is busy 100-300, 300-400 (overlapping
    launches merge) and 600-700."""
    return [
        Ev("amqbench.window", CPU, 0, 1000),
        Ev("amqbench.insert", CPU, 10, 90),
        Ev("aten::sort", CPU, 20, 60, corr=5),
        Ev("cudaLaunchKernel", CPU, 30, 31, corr=101),
        Ev("cudaLaunchKernel", CPU, 50, 51, corr=102),
        Ev("amqbench.restore", CPU, 500, 520),
        Ev("cudaMemcpyAsync", CPU, 505, 506, corr=103),
        Ev("amqbench.insert", CUDA, 100, 400),  # the span's shadow on the card
        Ev("DeviceRadixSortOnesweepKernel", CUDA, 100, 300, corr=101),
        Ev("build", CUDA, 250, 400, corr=102),
        Ev("Memcpy DtoD", CUDA, 600, 700, corr=103),
        Ev("orphan", CUDA, 800, 810, corr=999, linked=5),
    ]


def test_trace_reading():
    t = read_events(made_up_trace(), {"insert": 0})
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(410e-9)  # 100-400, 600-700, 800-810
    spans = {o.name: o.span for o in t.ops}
    assert spans == {"DeviceRadixSortOnesweepKernel": "insert", "build": "insert",
                     "Memcpy DtoD": "restore", "orphan": "insert"}
    assert t.device_s("insert") == pytest.approx(360e-9)
    ops = dict(t.breakdown["device_ops"])
    assert ops["DeviceRadixSortOnesweepKernel"] == pytest.approx(200e-9)
    gaps = dict(t.breakdown["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(590e-9)
    assert gaps["between spans"] == pytest.approx(590e-9)


def made_up_run(op="insert", trace=True):
    calls = [Call(issue_s=i * 0.1, host_s=0.002, keys=1000, mark=None) for i in range(20)]
    done = [c.issue_s + 0.05 + 0.001 * i for i, c in enumerate(calls)]
    record = Record(op, calls, 2.0, done)
    t = read_events(made_up_trace(), {"insert": 10}) if trace else None
    if t is not None and op == "probe":
        for o in t.ops:
            o.span = "probe" if o.span == "insert" else o.span
    return Run(op=op, record=record, setup_s=9.5, memory_peak_bytes=4000,
               capacity_keys=100, trace=t, counters={"probe_visits": 30000})


def test_readers_on_an_ingest_run():
    run = made_up_run("insert")
    value = {n: reader(n)(run) for n in _names()}
    assert value["ingest_keys_per_s"] == 10000
    assert value["insert_p95_ms"] == pytest.approx(68)  # the 19th of 20: 50 + 18
    assert value["device_bytes_per_key"] == 40
    assert value["setup_s"] == 9.5
    assert value["host_issue_ms.insert"] == pytest.approx(2)
    assert value["syncs_per_insert"] == 0.5
    assert value["sort_share_pct"] == pytest.approx(100 * 200 / 360)
    assert value["insert_roofline"] == pytest.approx(
        100 * 20000 * 68 / 3.35e12 / 360e-9)
    assert value["device_idle_pct.ingest"] == pytest.approx(59)
    for n in ("probe_queries_per_s", "host_issue_ms.probe", "probe_roofline",
              "device_idle_pct.probe"):
        assert value[n] is None


def test_readers_on_a_lookup_run():
    run = made_up_run("probe")
    value = {n: reader(n)(run) for n in _names()}
    assert value["probe_queries_per_s"] == 10000
    assert value["probe_roofline"] == pytest.approx(
        100 * (20000 * 5 + 30000 * 32) / 3.35e12 / 360e-9)
    assert value["device_idle_pct.probe"] == pytest.approx(59)
    for n in ("ingest_keys_per_s", "insert_p95_ms", "syncs_per_insert", "sort_share_pct"):
        assert value[n] is None


def test_per_layer_readers_need_the_trace():
    run = made_up_run("insert", trace=False)
    for m in spec.benchmark()["per_layer"]:
        assert reader(m["name"])(run) is None


def test_read_leaves_out_what_a_run_lacks():
    entries = spec.benchmark()["end_to_end"]
    got = metrics.read(entries, made_up_run("insert", trace=False))
    assert set(got) == {"ingest_keys_per_s", "insert_p95_ms", "device_bytes_per_key", "setup_s"}
    assert got["insert_p95_ms"]["unit"] == "ms"


def _names():
    b = spec.benchmark()
    return [m["name"] for m in b["end_to_end"] + b["per_layer"]]


def test_every_metric_has_a_reader():
    for n in _names():
        assert callable(reader(n))


@pytest.mark.parametrize("n", [8, 24, 4096, 13])
def test_count_is_the_sum(n):
    hits = torch.rand(n, generator=torch.Generator().manual_seed(n)) < 0.3
    assert int(window.count(hits)) == int(hits.sum())


def test_digest_sees_one_change_and_a_swap():
    s = {"rem": torch.arange(64, dtype=torch.int32), "occ": torch.zeros(64, dtype=torch.bool),
         "shf": torch.zeros(64, dtype=torch.bool), "con": torch.zeros(64, dtype=torch.bool),
         "n": torch.tensor(5, dtype=torch.int32), "overflow": torch.tensor(False)}
    d = check.digest([s])
    one = dict(s, rem=s["rem"].clone())
    one["rem"][7] += 1
    swap = dict(s, rem=s["rem"].clone())
    swap["rem"][[3, 40]] = swap["rem"][[40, 3]]
    flag = dict(s, occ=s["occ"].clone())
    flag["occ"][63] = True
    for other in (one, swap, flag, dict(s, n=torch.tensor(6, dtype=torch.int32))):
        assert not torch.equal(check.digest([other]), d)
    assert torch.equal(check.digest([dict(s)]), d)


def test_spread_arithmetic():
    sp = importlib.util.spec_from_file_location("spread", spec.BENCH / "spread.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    assert mod.spread([100, 100, 100, 100]) == 0
    assert mod.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)
    assert mod.trimmed([10, 11, 12, 50]) == [10, 11, 12]
    out = mod.summary([[{"x": v} for v in (99, 100, 101, 100)], [{"x": 100}] * 4])
    assert out["x"]["spreads"][1] == 0
    assert out["x"]["suggested_bound"] == pytest.approx(5 * out["x"]["spreads"][0])
    assert mod.summary([[{"x": 7}] * 4])["x"]["suggested_bound"] == 0.01
