"""The program's spans in a traced run (``harness/scopes.py``) and the
readers that read them: program spans leave every reader that was there
as it was; the arithmetic of device time at any depth, host time and
self time; a traced run of each small cell holds every span a reader
looks for; and, on the card, each span's device operations launched in
it and counted by the wrappers' ``launches``."""

import time

import pytest
import torch

from amqbench.harness import cell as runner
from amqbench.harness import scopes, spec
from amqbench.harness.metrics import Run, module, reader
from amqbench.harness.trace import Tracer, read_events
from amqbench.harness.window import Call, Record
from cells import SMALL, small_cell
from test_amqbench_metrics import CPU, CUDA, Ev, made_up_run, made_up_trace

NEW = ("extract_ms.insert", "sort_ms.insert", "build_ms.insert", "collapse_ms.insert",
       "host_wait_ms.insert", "unpack_ms.probe", "facade_self_ms.point")


def program_events():
    """The port's spans inside the made-up insert span (10-90): the sort
    kernel launched at 30 under ``qf.sort``, the build kernel at 50 under
    ``kernels.qf_build_planes`` inside ``qf.build``, a host read."""
    return [
        Ev("repro_torch.filters.insert", CPU, 12, 88, corr=201),
        Ev("repro_torch.qf.sort", CPU, 25, 45, corr=202),
        Ev("repro_torch.qf.build", CPU, 48, 60, corr=203),
        Ev("repro_torch.kernels.qf_build_planes", CPU, 49, 55, corr=204),
        Ev("repro_torch.host_read.cascade._collapse_target", CPU, 70, 85, corr=205),
    ]


def probe_events():
    """A probe span with the cascade lookup's spans, each launching one kernel."""
    return [
        Ev("amqbench.window", CPU, 0, 1000),
        Ev("amqbench.probe", CPU, 10, 90),
        Ev("repro_torch.filters.contains", CPU, 12, 88, corr=300),
        Ev("repro_torch.kernels.fingerprint", CPU, 14, 20, corr=301),
        Ev("cudaLaunchKernel", CPU, 15, 16, corr=401),
        Ev("repro_torch.kernels.cascade_probe", CPU, 22, 40, corr=302),
        Ev("cudaLaunchKernel", CPU, 30, 31, corr=402),
        Ev("repro_torch.kernels.unpack", CPU, 42, 60, corr=303),
        Ev("cudaLaunchKernel", CPU, 50, 51, corr=403),
        Ev("repro_torch.cascade.combine", CPU, 62, 80, corr=304),
        Ev("cudaLaunchKernel", CPU, 70, 71, corr=404),
        Ev("fingerprint_kernel", CUDA, 100, 110, corr=401),
        Ev("cascade_probe_kernel", CUDA, 110, 300, corr=402),
        Ev("elementwise", CUDA, 300, 340, corr=403),
        Ev("elementwise", CUDA, 340, 350, corr=404),
    ]


def _old_names():
    b = spec.benchmark()
    return [m["name"] for m in b["end_to_end"] + b["per_layer"] if m["name"] not in NEW]


def _reading(trace):
    return (trace.window_s, trace.busy_s, [(o.name, o.start_ns, o.end_ns, o.span)
                                           for o in trace.ops], trace.syncs, trace.breakdown)


@pytest.mark.parametrize("op", ["insert", "probe"])
def test_program_spans_leave_every_reader_as_it_was(op):
    plain, spanned = made_up_run(op), made_up_run(op)
    spanned.trace = read_events(made_up_trace() + program_events(), {"insert": 10})
    if op == "probe":
        for o in spanned.trace.ops:
            o.span = "probe" if o.span == "insert" else o.span
    assert _reading(spanned.trace) == _reading(plain.trace)
    for n in _old_names():
        assert reader(n)(spanned) == reader(n)(plain), n


def test_device_host_and_self_time_by_span():
    p = scopes.read(made_up_trace() + program_events()
                    + [Ev("repro_torch.qf.sort", CUDA, 100, 300)])  # a shadow is no operation
    assert p.names == ["filters.insert", "qf.sort", "qf.build", "kernels.qf_build_planes",
                       "host_read.cascade._collapse_target"]
    assert p.parent == [-1, 0, 0, 2, 0]
    assert p.span == ["insert"] * 5
    assert p.device_s("insert", ("qf.sort",)) == pytest.approx(200e-9)
    assert p.device_s("insert", ("qf.build",)) == pytest.approx(150e-9)  # at any depth
    assert p.device_s("insert", ("kernels.qf_build_planes",)) == pytest.approx(150e-9)
    assert p.device_s("insert", ("filters.insert",)) == pytest.approx(360e-9)  # the orphan too
    assert p.device_s("insert", ("qf.build", "kernels")) == pytest.approx(150e-9)  # once
    assert p.host_s("insert", ("host_read",)) == pytest.approx(15e-9)
    assert p.self_s("insert", ("filters.insert",)) == pytest.approx((76 - 20 - 12 - 15) * 1e-9)
    assert p.self_s("insert", ("qf.build",)) == pytest.approx(6e-9)
    assert p.coverage("insert") == pytest.approx(350 / 360)
    assert p.coverage("restore") == 0
    assert p.loose_ns == {"restore": 100}
    assert [scopes.innermost(p, t) for t in (5, 12, 30, 50, 57, 65, 95)] == [-1, 0, 1, 3, 2, 0, -1]
    assert p.has(("cascade.collapse", "qf.extract")) is False
    assert p.has(("host_read",))


def _with_program(run, events):
    run.trace = read_events(events, {"insert": 10})
    setattr(run.trace, scopes._KEPT, scopes.read(events))
    return run


def test_readers_of_program_spans():
    ingest = _with_program(made_up_run("insert"), made_up_trace() + program_events())
    probe = _with_program(made_up_run("probe"), probe_events())
    got = {n: (reader(n)(ingest), reader(n)(probe)) for n in NEW}
    calls = 20
    assert got["sort_ms.insert"] == (pytest.approx(200e-9 / calls * 1e3), None)
    assert got["build_ms.insert"] == (pytest.approx(150e-9 / calls * 1e3), None)
    assert got["host_wait_ms.insert"] == (pytest.approx(15e-9 / calls * 1e3), None)
    assert got["unpack_ms.probe"] == (None, pytest.approx(50e-9 / calls * 1e3))
    assert got["facade_self_ms.point"] == (None, pytest.approx(16e-9 / calls * 1e3))
    for n in ("extract_ms.insert", "collapse_ms.insert"):  # no such span: nothing to read
        assert got[n] == (None, None)
    assert probe.trace.program.coverage("probe") == 1
    lines = probe.trace.program.lines("probe", calls)
    assert "span kernels.unpack: 1 (0.05 a call), host 9e-07 ms a call, device 2e-06 ms a call" \
        in lines
    assert lines[-1].startswith("span coverage of probe: 100.0000%")


def test_a_reader_finds_the_tracer_of_the_run(capsys):
    from repro_torch import filters

    cfg, state = filters.make("qf", device="cpu", q=8, r=8, backend="pallas")
    keys = torch.arange(64, dtype=torch.int32)
    tracer = Tracer("cpu")
    tracer.open()
    with tracer.span("insert"):
        state = filters.insert(cfg, state, keys)
    tracer.close()
    run = Run(op="insert", record=Record("insert", [Call(0.0, 0.001, 64, 0.001)], 0.01, [0.001]),
              setup_s=0.0, memory_peak_bytes=0, capacity_keys=192, trace=tracer.read())
    assert reader("extract_ms.insert")(run) == 0  # no device on the CPU
    assert reader("host_wait_ms.insert")(run) is None  # a flat filter reads nothing
    assert "span qf.extract: 1 (1 a call)" in capsys.readouterr().err


def _reading_cells():
    """The small cells whose benchmark cell reports a reader of program spans."""
    per_layer = spec.benchmark()["per_layer"]
    return [n for n, (_, _, like) in sorted(SMALL.items())
            if any(m["name"] in NEW for m in spec.metrics_of(per_layer, like))]


@pytest.mark.parametrize("name", _reading_cells())
def test_a_traced_small_cell_holds_every_span_its_readers_read(name, monkeypatch, capsys):
    read = []
    monkeypatch.setattr(scopes, "read", lambda events, real=scopes.read: read.append(
        real(events)) or read[-1])
    cell = small_cell(name)
    result, _ = runner.run(cell, 2**31 + 9, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"]
    mine = [m["name"] for m in cell.per_layer if m["name"] in NEW]
    names = set(read[0].names)
    for m in mine:
        for want in module(m).SPANS:
            assert any(scopes.matches(n, (want,)) for n in names), (m, want)
        assert m in result["metrics"], m
    assert f"span coverage of {'insert' if 'ingest' in name else 'probe'}" in capsys.readouterr().err


def test_without_program_spans_the_readers_read_nothing(monkeypatch, capsys):
    """A program that opens no span, as before the spans: the new metrics
    are left out of the line, and every other one is read."""
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    cell = small_cell("cascade.ingest")
    result, _ = runner.run(cell, 2**31 + 9, 0.3, True, "cpu", time.perf_counter())
    listed = {m["name"] for m in cell.per_layer}
    assert result["correct"] and listed & set(NEW)
    assert not set(result["metrics"]) & set(NEW)
    assert "host_issue_ms.insert" in result["metrics"]
    assert "span lines: the trace holds no program span" in capsys.readouterr().err


WRAPPERS = {"fingerprint": "fingerprint", "qf_positions": "qf_build", "qf_build_planes": "qf_build",
            "cascade_probe": "cascade_probe", "qf_probe": "qf_probe"}


def _launches():
    import importlib

    return {w: importlib.import_module(f"repro_torch.kernels.{m}").__dict__[w].launches
            for w, m in WRAPPERS.items()}


@pytest.mark.card
def test_on_the_card_a_span_holds_the_launches_of_its_operations(card):
    from repro_torch import filters

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    g = torch.Generator(device=card).manual_seed(5)
    qcfg, qf = filters.make("qf", device=card, q=24, r=12, backend="pallas")
    ccfg, cf = filters.make("cascade", device=card, ram_q=16, p=30, fanout=2, levels=3,
                            backend="pallas")
    batch = torch.randint(0, 2**31 - 1, (1 << 20,), dtype=torch.int32, device=card, generator=g)
    qf = filters.insert(qcfg, qf, batch)  # the libraries built, every shape run once
    for b in range(8):
        cf = filters.insert(ccfg, cf, batch[b * 20000:(b + 1) * 20000])
    filters.contains(ccfg, cf, batch)
    torch.cuda.synchronize()
    before = _launches()
    with torch.profiler.profile(activities=acts) as prof:
        qf = filters.insert(qcfg, qf, batch)
        filters.contains(ccfg, cf, batch)
        torch.cuda.synchronize()
    grown = {w: n - before[w] for w, n in _launches().items()}
    events = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.end_ns(), e.name()[len(scopes.PROGRAM):]) for e in events
             if e.device_type() == torch.autograd.DeviceType.CPU
             and e.name().startswith(scopes.PROGRAM)]
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(("cuda", "cuLaunch"))}
    ops = [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU
           and not e.name().startswith(("amqbench.", scopes.PROGRAM))]
    for w in WRAPPERS:
        assert grown[w] == sum(n == f"kernels.{w}" for _, _, n in spans), w
    assert grown["qf_probe"] == 0 and grown["cascade_probe"] == 1
    for name, kernel in (("qf.build", "qf_build_kernel"),
                         ("kernels.cascade_probe", "cascade_probe_kernel")):
        (s, e), = [(s, e) for s, e, n in spans if n == name]
        inside = [o for o in ops if s <= launches.get(o.correlation_id(), -1) <= e]
        assert any(kernel in o.name() for o in inside), name
        for o in inside:
            assert o.start_ns() >= launches[o.correlation_id()], o.name()
    p = scopes.read(events)
    assert p.device_s("", ("qf.build",)) > 0 and p.device_s("", ("kernels.cascade_probe",)) > 0
