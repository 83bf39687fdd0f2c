"""The port's spans (``repro_torch.tracing``): off, they are one shared
no-op and record nothing; under a CPU ``torch.profiler`` the insert and
lookup paths open the spans of each layer, nested as the module's
docstring says; a cascade's ``cascade.collapse.L<i>`` spans follow the
merge schedule of the benchmark's plain reference; and the op audit's
committed ``cpu`` manifest still holds for the families that open them.
"""

import importlib
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import filters, tracing
from repro_torch.analysis import trace_audit

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.profiler.ProfilerActivity.CPU

QF = dict(q=10, r=8, slack=64, backend="pallas")
CASCADE = dict(ram_q=6, p=20, fanout=2, levels=3, backend="pallas")
BATCH = 18  # three cascade batches fill Q0 (48 of 64 buckets at load 0.75)


def _keys(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, generator=g)


def _spans(prof):
    """``(start, end, name)`` of every ``repro_torch.`` event, by start."""
    out = [
        (e.start_ns(), e.end_ns(), e.name()[len(tracing.PREFIX):])
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(tracing.PREFIX)
    ]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _edges(spans):
    """``(parent, child)`` names of the nested spans; "" for the outermost."""
    edges, stack = set(), []
    for s, e, name in spans:
        while stack and stack[-1][1] < e:
            stack.pop()
        edges.add((stack[-1][2] if stack else "", name))
        stack.append((s, e, name))
    return edges


def _profiled(run):
    """The spans ``run()`` opens under a CPU profiler."""
    with torch.profiler.profile(activities=[CPU]) as prof:
        run()
    return _spans(prof)


def test_off_a_span_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} opened with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert tracing.span("qf.sort") is tracing.span("filters.insert")
    cfg, state = filters.make("qf", device="cpu", **QF)
    state = filters.insert(cfg, state, _keys(64, 0))
    assert bool(filters.contains(cfg, state, _keys(64, 0)).all())


def _qf_insert(backend="pallas"):
    cfg, state = filters.make("qf", device="cpu", **dict(QF, backend=backend))
    return _profiled(lambda: filters.insert(cfg, state, _keys(300, 1)))


def _qf_contains():
    cfg, state = filters.make("qf", device="cpu", **QF)
    state = filters.insert(cfg, state, _keys(300, 1))
    return _profiled(lambda: filters.contains(cfg, state, _keys(8, 1)))


def _cascade_filled(n_batches):
    cfg, state = filters.make("cascade", device="cpu", **CASCADE)
    for b in range(n_batches):
        state = filters.insert(cfg, state, _keys(BATCH, 10 + b))
    return cfg, state


def _cascade_insert():
    cfg, state = _cascade_filled(2)
    return _profiled(lambda: filters.insert(cfg, state, _keys(BATCH, 12)))  # fills Q0


def _cascade_contains():
    cfg, state = _cascade_filled(4)
    return _profiled(lambda: filters.contains(cfg, state, _keys(8, 10)))


def _cascade_merge():
    cfg, a = _cascade_filled(2)
    _, b = _cascade_filled(1)
    return _profiled(lambda: filters.merge(cfg, a, b))


def _buffered_insert():
    cfg, state = filters.make("buffered_qf", device="cpu", ram_q=6, disk_q=10, p=20)
    return _profiled(lambda: filters.insert(cfg, state, _keys(56, 2)))


def _steady_insert():
    cfg, state = filters.make("steady_qf", device="cpu", q=10, r=8, buf_q=8)
    return _profiled(lambda: filters.insert(cfg, state, _keys(32, 3)))


KERNEL_QF = {("", "filters.insert"), ("filters.insert", "qf.fingerprint"),
             ("qf.fingerprint", "kernels.fingerprint"), ("filters.insert", "qf.sort"),
             ("filters.insert", "qf.extract"), ("filters.insert", "qf.build"),
             ("qf.build", "kernels.qf_positions"), ("qf.build", "kernels.qf_build_planes"),
             ("qf.extract", "kernels.qf_decode")}

CASES = {
    "qf.insert": (_qf_insert, KERNEL_QF),
    "qf.insert.reference": (lambda: _qf_insert("reference"), {
        ("", "filters.insert"), ("filters.insert", "qf.fingerprint"),
        ("filters.insert", "qf.sort"), ("filters.insert", "qf.extract"),
        ("filters.insert", "qf.build")}),
    "qf.contains": (_qf_contains, {
        ("", "filters.contains"), ("filters.contains", "kernels.fingerprint"),
        ("filters.contains", "kernels.qf_probe")}),
    "cascade.insert": (_cascade_insert, KERNEL_QF | {
        ("filters.insert", "host_read.cascade._collapse_target"),
        ("filters.insert", "cascade.collapse.L0"),
        ("cascade.collapse.L0", "cascade.merge_streams"),
        ("cascade.merge_streams", "qf.extract"), ("cascade.collapse.L0", "qf.build")}),
    "cascade.contains": (_cascade_contains, {
        ("", "filters.contains"), ("filters.contains", "kernels.fingerprint"),
        ("filters.contains", "kernels.cascade_probe"), ("filters.contains", "kernels.unpack"),
        ("filters.contains", "cascade.combine")}),
    "cascade.merge": (_cascade_merge, {
        ("", "host_read.cascade.merge"), ("", "qf.build")}),
    "buffered_qf.insert": (_buffered_insert, {
        ("filters.insert", "host_read.buffered.insert")}),
    "steady_qf.insert": (_steady_insert, {
        ("filters.insert", "host_read.steady.insert")}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_by_layer(case):
    run, want = CASES[case]
    spans = run()
    edges = _edges(spans)
    assert want <= edges, sorted(want - edges)
    assert all(name.split(".")[0] in {"filters", "qf", "cascade", "kernels", "host_read"}
               for _, _, name in spans)


def _reference_cascade():
    """The benchmark's plain reference of the cascade (``amqbench/reference``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("amqbench.reference.cascade")


def test_collapse_spans_follow_the_reference_schedule():
    ref = _reference_cascade()
    model = ref.Model(CASCADE, "cpu")
    want = []
    real = model.collapse_target
    model.collapse_target = lambda: want.append(real()) or want[-1]
    cfg, state = filters.make("cascade", device="cpu", **CASCADE)
    batches = [_keys(BATCH, 100 + b) for b in range(16)]
    with torch.profiler.profile(activities=[CPU]) as prof:
        for keys in batches:
            state = filters.insert(cfg, state, keys)
    for keys in batches:
        model.insert(keys)
    spans = _spans(prof)
    got = []
    for s, e, name in spans:
        if name == "filters.insert":
            inside = [n for s2, e2, n in spans if s <= s2 and e2 <= e
                      and n.startswith("cascade.collapse.L")]
            assert len(inside) <= 1
            got.append(int(inside[0][len("cascade.collapse.L"):]) if inside else None)
    assert got == want
    assert {0, 1, 2} <= set(want)  # merges into three levels


@pytest.mark.parametrize("family", ["cascade", "buffered_qf"])
def test_op_audit_manifest_unchanged(family):
    cur = trace_audit.collect(families=[family])
    man = trace_audit.load_manifest(device="cpu")
    sub = {"families": {k: v for k, v in man["families"].items() if k in cur["families"]}}
    assert family in sub["families"]
    lines, ok = trace_audit.diff(cur, sub, strict=True)
    assert ok, "\n".join(lines)
