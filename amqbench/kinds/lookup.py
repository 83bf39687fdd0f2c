"""Lookup: the window probes a pool of batches in turn.

Parameters, besides the common ones (``harness/traffic.py``):

- ``member_share``: the share of each batch drawn uniformly from the
  keys inserted in set-up, the rest uniform over all 2**32 keys;
- ``pool_batches``: distinct batches, made in set-up in one draw and
  probed in turn in the window;
- ``warmup_calls``: the first pool batches, probed once in set-up so
  that every shape of the window has run once before it;
- ``answers``: ``"count"``: each call's hits are summed on the device
  (a few launches a call), and ``sample_calls`` calls, drawn from the
  seed, are kept whole; ``"all"``: every call's answers are kept (no
  launch of the benchmark's own between calls), for small batches;
- ``sample_calls``: with ``"count"``, the calls kept whole.

Checked once the window has closed: the set-up state against the
reference's (the family's ``compare``); ``answer_mismatches``, answers
of the kept calls that differ from exact fingerprint membership;
``false_negatives``, rows of the kept calls drawn from the inserted
keys that the program answered absent; ``hit_count_gap``, |hits summed
over every call - the reference's sum over the same calls|.  A traced run also counts, by the
reference, the structures each probe must read (``probe_visits``).
"""

from __future__ import annotations

import torch

from ..harness import window as win
from ..harness.traffic import POOL, generator, uniform_keys
from ..reference import family
from . import reference

OP = "probe"
PARAMS = ("member_share", "pool_batches", "warmup_calls", "answers", "sample_calls")


def validate(params: dict) -> None:
    if not params["prefill_keys"]:
        raise ValueError("a lookup mix draws members from its set-up keys: prefill_keys > 0")
    if not 0 <= params["member_share"] <= 1:
        raise ValueError("member_share is a share, 0 to 1")
    if params["answers"] not in ("count", "all"):
        raise ValueError("answers is count or all")
    if min(params["pool_batches"], params["sample_calls"]) < 1:
        raise ValueError("pool_batches and sample_calls must be at least 1")


def pool(traffic, members: torch.Tensor):
    """The pool, ``(queries, drawn)``, each ``[pool_batches, batch_keys]``:
    in each row ``round(batch_keys * member_share)`` keys drawn from
    ``members``, the rest uniform, in an order drawn per row; ``drawn``
    marks the rows' keys drawn from ``members``."""
    g = generator(traffic.device, traffic.seed, POOL)
    p, n = traffic.pool_batches, traffic.batch_keys
    k = int(round(n * traffic.member_share))
    at = torch.randint(0, members.shape[0], (p, k), generator=g, device=traffic.device)
    fresh = uniform_keys(p * (n - k), g, traffic.device).view(p, n - k)
    order = torch.rand(p, n, generator=g, device=traffic.device).argsort(dim=1)
    queries = torch.cat([members[at], fresh], dim=1).gather(1, order)
    return queries, order < k


def setup(engine, state, traffic, prefill):
    queries, _ = pool(traffic, torch.cat(prefill))
    for b in range(min(traffic.warmup_calls, traffic.pool_batches)):
        win.count(engine.contains(state, queries[b]))
    return state, {"queries": queries}


def window(engine, state, traffic, plan, seconds, tracer):
    """Probe the pool's batches in turn until ``seconds`` pass.  The
    outcome: the hit sum (with ``"count"``), the calls of each pool
    batch and the kept calls' ``(batch, answers)``."""
    queries = plan["queries"]
    keep_all = traffic.answers == "all"
    kept = []
    clock = win.Clock(traffic.device)
    calls = []
    hits_sum = torch.zeros((), dtype=torch.int64, device=traffic.device)
    per_batch = [0] * traffic.pool_batches
    sample = win.Sample(traffic.sample_calls, traffic.seed)
    tracer.open()
    clock.start()
    while clock.now() < seconds:
        win.wait_turn(calls, traffic.in_flight, clock)
        b = len(calls) % traffic.pool_batches
        t = clock.now()
        with tracer.span("probe"):
            hits = engine.contains(state, queries[b])
        host = clock.now() - t
        if keep_all:
            kept.append((b, hits))
        else:
            with tracer.span("count"):
                hits_sum += win.count(hits)
            sample.offer((b, hits))
        calls.append(win.Call(t, host, hits.shape[0], clock.mark()))
        per_batch[b] += 1
    window_s = clock.finish()
    tracer.close()
    outcome = {"hits_sum": None if keep_all else hits_sum, "per_batch": per_batch,
               "kept": kept if keep_all else sample.kept}
    return state, win.record(OP, calls, clock, window_s), outcome


def expect(cell, engine, state, traffic, plan, outcome, trace):
    plan.clear()  # the pool: the reference makes its own
    m, prefill = reference(cell, traffic)
    numbers = family(cell.config).compare(engine.structures(state), m.structures())
    queries, drawn = pool(traffic, torch.cat(prefill))
    del prefill
    expected = m.contains(queries.reshape(-1)).view_as(queries)
    rows = torch.tensor([b for b, _ in outcome["kept"]], dtype=torch.int64,
                        device=expected.device)
    got = torch.stack([h for _, h in outcome["kept"]])
    bad = got != expected[rows]
    missed = drawn[rows] & ~got
    failed = int((bad | missed).any(dim=1).sum())
    n = torch.tensor(outcome["per_batch"], dtype=torch.int64, device=expected.device)
    want = int((expected.sum(dim=1) * n).sum())
    hits_sum = got.sum() if outcome["hits_sum"] is None else outcome["hits_sum"]
    numbers["answer_mismatches"] = int(bad.sum())
    numbers["false_negatives"] = int(missed.sum())
    numbers["hit_count_gap"] = abs(int(hits_sum) - want)
    counters = {}
    if trace:
        used = n > 0
        visits = m.visits(queries[used].reshape(-1)).view(-1, traffic.batch_keys)
        counters["probe_visits"] = int((visits.sum(dim=1) * n[used]).sum())
    return numbers, failed, counters
