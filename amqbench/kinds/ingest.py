"""Ingest: the window inserts the cycle's batches in turn.

Parameters, besides the common ones (``harness/traffic.py``):

- ``cycle_batches``: batches inserted after the set-up state before the
  state is restored to it, in the window, so that the load stays in its
  band; the same batches repeat every cycle;
- ``warmup_calls``: inserts made in set-up, then undone, so that every
  shape of the window has run once before it (a cascade needs a whole
  cycle for every level's merge);
- ``whole_cycles``: if true, once ``seconds`` have passed the window
  runs on to the end of the cycle in progress, so that it holds whole
  cycles, each the same work; if false it closes at ``seconds``.

Checked: the final state against the reference's after the same
batches (the family's ``compare``), and the digest of each state thrown
away at a restore against the reference's state at the cycle's end
(``restore_digests``).
"""

from __future__ import annotations

from ..harness import check
from ..harness import window as win
from ..harness.traffic import WINDOW, generator, uniform_keys
from ..reference import family
from . import reference

OP = "insert"
PARAMS = ("cycle_batches", "warmup_calls", "whole_cycles")


def validate(params: dict) -> None:
    if params["cycle_batches"] < 1:
        raise ValueError("cycle_batches must be at least 1")


def batch(traffic, j: int):
    """The j-th batch of a cycle."""
    g = generator(traffic.device, traffic.seed, WINDOW, j)
    return uniform_keys(traffic.batch_keys, g, traffic.device)


def setup(engine, state, traffic, prefill):
    batches = [batch(traffic, j) for j in range(traffic.cycle_batches)]
    snap = engine.snapshot(state) if traffic.prefill_keys else None
    for j in range(traffic.warmup_calls):
        state = engine.insert(state, batches[j % len(batches)])
    check.digest(engine.structures(state))
    return engine.restore(state, snap), {"batches": batches, "snap": snap}


def window(engine, state, traffic, plan, seconds, tracer):
    """Insert the cycle's batches in turn until ``seconds`` pass (and,
    with ``whole_cycles``, the cycle ends), putting the state back to
    the snapshot (emptying it, without one) before the batch that would
    pass the cycle's end.  The outcome: each restored state's digest,
    and the batches since the last restore."""
    batches, snap = plan["batches"], plan["snap"]
    clock = win.Clock(traffic.device)
    calls, digests, pos = [], [], 0
    tracer.open()
    clock.start()
    while clock.now() < seconds or (traffic.whole_cycles and pos < len(batches)):
        if pos == len(batches):
            with tracer.span("restore"):
                digests.append(check.digest(engine.structures(state)))
                state = engine.restore(state, snap)
            pos = 0
        win.wait_turn(calls, traffic.in_flight, clock)
        keys = batches[pos]
        t = clock.now()
        with tracer.span("insert", syncs=True):
            state = engine.insert(state, keys)
        calls.append(win.Call(t, clock.now() - t, keys.shape[0], clock.mark()))
        pos += 1
    window_s = clock.finish()
    tracer.close()
    return state, win.record(OP, calls, clock, window_s), {"digests": digests, "pos": pos}


def expect(cell, engine, state, traffic, plan, outcome, trace):
    plan.clear()  # the snapshot and batches: the reference makes its own
    m, _ = reference(cell, traffic)
    digests, pos = outcome["digests"], outcome["pos"]
    restore = 0
    if digests:
        full = m.copy()
        for j in range(traffic.cycle_batches):
            full.insert(batch(traffic, j))
        restore = check.restore_mismatches(digests, check.digest(full.structures()))
        del full
    for j in range(pos):
        m.insert(batch(traffic, j))
    numbers = family(cell.config).compare(engine.structures(state), m.structures())
    failed = restore + int(any(numbers.values()))
    numbers["restore_digests"] = restore
    return numbers, failed, {}

