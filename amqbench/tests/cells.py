"""Small cells of both families and both kinds, for runs on the CPU."""

from amqbench.harness.spec import Cell, benchmark, metrics_of

QF = {"name": "qf-small", "family": "qf",
      "spec": {"q": 10, "r": 8, "slack": 64, "seed": 0, "max_load": 0.75, "backend": "pallas"}}
CASCADE = {"name": "cascade-small", "family": "cascade",
           "spec": {"ram_q": 6, "p": 20, "fanout": 2, "levels": 3, "seed": 0,
                    "max_load": 0.75, "backend": "pallas"}}
INGEST = {"kind": "ingest", "prefill_keys": 256, "prefill_batch_keys": 256, "batch_keys": 32,
          "cycle_batches": 8, "in_flight": 2, "warmup_calls": 2, "whole_cycles": False}
CASCADE_INGEST = {"kind": "ingest", "prefill_keys": 0, "prefill_batch_keys": 18,
                  "batch_keys": 18, "cycle_batches": 16, "in_flight": 2, "warmup_calls": 16,
                  "whole_cycles": True}
LOOKUP = {"kind": "lookup", "prefill_keys": 768, "prefill_batch_keys": 768, "batch_keys": 512,
          "member_share": 0.5, "pool_batches": 3, "warmup_calls": 3, "answers": "count",
          "sample_calls": 8,
          "in_flight": 4}
CASCADE_LOOKUP = dict(LOOKUP, prefill_keys=288, prefill_batch_keys=18)
POINT = dict(LOOKUP, batch_keys=8, pool_batches=64, warmup_calls=2, answers="all", in_flight=1)

# (small cell, the cell of BENCHMARK.json whose metrics it reports)
SMALL = {
    "qf.ingest": (QF, INGEST, "qf-r12-q29.ingest"),
    "cascade.ingest": (CASCADE, CASCADE_INGEST, "cascade-f2-1to24.ingest"),
    "qf.lookup": (QF, LOOKUP, "qf-r12-q29.lookup"),
    "cascade.lookup": (CASCADE, CASCADE_LOOKUP, "cascade-f2-1to24.lookup"),
    "qf.multiget": (QF, POINT, "qf-r12-q29.multiget"),
}


def small_cell(name: str) -> Cell:
    config, traffic, like = SMALL[name]
    b = benchmark()
    return Cell(name, config, traffic, 1, metrics_of(b["end_to_end"], like),
                metrics_of(b["per_layer"], like))
