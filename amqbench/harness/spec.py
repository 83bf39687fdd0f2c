"""What a cell is: its entry in ``BENCHMARK.json`` and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), each naming a configuration and a traffic mix, and the
metrics, each with the cells it is read in.  All found by name, so that
each is added by adding files and none is edited:

- a configuration is ``configs/<name>.json`` (its ``file``), and its
  family's reference ``reference/<family>.py``;
- a traffic mix is ``traffic/<name>.json``, parameters only, and its
  ``kind`` names the code that drives it, ``kinds/<kind>.py``;
- a metric's reader is ``metrics/<name>.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

from .. import kinds
from ..reference import model

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def design_capacity(config: dict) -> int:
    """Keys the configuration is built to hold, by its reference: for
    quotient filters ``max_load`` times the buckets of every filter in
    it, each rounded down as the filters round their capacity."""
    return model(config)(config["spec"], "meta").capacity()


def load_config(path: Path) -> dict:
    config = read_json(path)
    stated = config.get("design_capacity_keys")
    if stated is not None and stated != design_capacity(config):
        raise ValueError(
            f"{path.name}: design_capacity_keys {stated} is not the "
            f"{design_capacity(config)} its spec holds"
        )
    return config


def metrics_of(entries: list, cell: str) -> list:
    """The metric entries whose ``workloads`` list ``cell``, or that have
    no such list."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        name=name,
        config=load_config(root / conf["file"]),
        traffic=kinds.validate(read_json(BENCH / "traffic" / f"{w['traffic']}.json")),
        chips=w["chips"],
        end_to_end=metrics_of(bench["end_to_end"], name),
        per_layer=metrics_of(bench["per_layer"], name),
    )
