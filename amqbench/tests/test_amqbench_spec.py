"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units, bounds and files, and that every cell reports what it must."""

import json
import re

import pytest

from amqbench.harness import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape():
    assert set(B) == KEYS["top"]
    assert B["command"][:2] == ["python3", "amqbench/run.py"] and len(B["command"]) <= 32
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    cells = 24  # what a full check must hold, as later PRs add cells
    assert (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(section):
    kind = {"configs": "config", "workloads": "workload"}.get(section, section)
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "source", "layer"):
            if k in e:
                assert text(e[k]), (e["name"], k)


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("amqbench/configs/")
        config = spec.load_config(spec.ROOT / c["file"])
        assert config["name"] == c["name"]
        assert set(c["reduced"]) == set(config["reduced"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and k not in ("r", "p")


def test_cells():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert len(B["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"])
    for w in B["workloads"]:
        cell = spec.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_metrics():
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["end_to_end"] + B["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_traffic_file_is_used_or_kept_for_later():
    used = {w["traffic"] for w in B["workloads"]}
    assert used <= {p.stem for p in (spec.BENCH / "traffic").glob("*.json")}
    for name in used:
        json.loads((spec.BENCH / "traffic" / f"{name}.json").read_text())
