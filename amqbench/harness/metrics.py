"""Metric readers, found by name: ``metrics/<name>.py`` defines ``read(run)``.

A reader takes a ``Run``, what one run measured, and returns the
metric's value, or ``None`` where the run has nothing for it to read;
the harness then leaves the metric out of the line.  Each reader holds
its own arithmetic (byte counts, kernel-name patterns, percentiles).
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field

from .spec import BENCH

# one NVIDIA H100 SXM's HBM3, from NVIDIA's data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Run:
    op: str  # what the window's calls did: "insert" or "probe"
    record: object  # window.Record
    setup_s: float
    memory_peak_bytes: int
    capacity_keys: int
    trace: object = None  # trace.Trace, in a traced run
    counters: dict = field(default_factory=dict)


def module(name: str):
    """The module of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("amqbench.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return module(name).read


def read(entries: list, run: Run) -> dict:
    """``{name: {"value", "unit"}}`` for each metric entry the run can read."""
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
