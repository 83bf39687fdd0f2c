"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the filter on the device, inserts the mix's set-up batches
through the program's insert calls, and has the mix's kind make every
call the window will make once (an ingest kind then undoes it).  The
window runs with the device memory's peak reset when it opens.  Once it has closed and the peak is
read, the plain reference works out, from the same keys, the states and
answers the window's calls should have produced, and every number
compared is printed beside its limit.
"""

from __future__ import annotations

import time

import torch

from . import check, metrics
from .. import kinds
from .engine import Port
from .spec import Cell, design_capacity
from .trace import NoTracer, Tracer
from .traffic import Traffic


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        engine=None) -> tuple:
    """Returns ``(result, check lines)``: the result's dict as the last
    line of the run prints it, and one line a number compared.  The
    cell's traffic kind (``kinds/<kind>.py``) makes the window's inputs,
    runs the window and works out what it should have produced."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = kinds.module(kinds.validate(cell.traffic)["kind"])
    traffic = Traffic(cell.traffic, seed, device)
    engine = engine or Port(cell.config, device)
    state = engine.make()
    if cuda:
        torch.cuda.synchronize()
    t_made = time.perf_counter()
    setup_peak = 0
    prefill = traffic.prefill_batches()
    for keys in prefill:
        state = engine.insert(state, keys)
    if cuda:  # the window's calls, not the set-up fill's, shape the allocator's cache
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
    t_filled = time.perf_counter()
    state, plan = kind.setup(engine, state, traffic, prefill)
    del prefill
    if cuda:
        torch.cuda.synchronize()
        setup_peak = max(setup_peak, torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.reset_accumulated_memory_stats()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(device) if trace else NoTracer()
    state, record, outcome = kind.window(engine, state, traffic, plan, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory = torch.cuda.memory_stats(device) if cuda else {}

    t_check = time.perf_counter()
    numbers, failed, counters = kind.expect(cell, engine, state, traffic, plan, outcome, trace)
    check_s = time.perf_counter() - t_check
    traced = tracer.read() if trace else None
    run_ = metrics.Run(
        op=record.op, record=record, setup_s=setup_s, memory_peak_bytes=peak,
        capacity_keys=design_capacity(cell.config), trace=traced, counters=counters,
    )
    entries = cell.per_layer if trace else cell.end_to_end
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {
        "correct": check.verdict(numbers),
        "attempted": len(record.calls),
        "failed": failed,
        "metrics": metrics.read(entries, run_),
        "device": dev,
    }
    if traced is not None:
        result["breakdown"] = traced.breakdown
    result["check"] = {k: {"value": v, "limit": check.LIMIT} for k, v in numbers.items()}
    lines = [
        f"set-up {setup_s:.3f} s: to the filter made {t_made - t_start:.3f}, fill "
        f"{t_filled - t_made:.3f}, the kind's set-up {t_start + setup_s - t_filled:.3f}",
        f"window {record.window_s:.3f} s, {len(record.calls)} calls; set-up peak "
        f"{setup_peak} B",
        f"memory window peak {peak} B, reserved peak "
        f"{memory.get('reserved_bytes.all.peak', 0)} B, allocation retries "
        f"{memory.get('num_alloc_retries', 0)}",
        f"reference check {check_s:.3f} s",
    ]
    if traced is not None:
        lines += [f"syncs {span} at {site}: {n}" for (span, site), n in
                  sorted(traced.sync_sites.items())]
    lines += [f"check {k} {v} limit {check.LIMIT}" for k, v in numbers.items()]
    return result, lines
