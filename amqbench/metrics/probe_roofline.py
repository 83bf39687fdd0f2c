"""The least time the window's probes could take on the card's memory
over the device time launched in its probe spans, %.

A probe must read its key (4 bytes), write its answer (1 byte) and read
one 32-byte sector in each non-empty quotient filter it consults, top
down, up to the first that holds its fingerprint (the run's
``probe_visits``, counted by the reference), at the HBM's 3.35 TB/s.
"""

from amqbench.harness.metrics import HBM_BYTES_PER_S

KEY_BYTES = 4
ANSWER_BYTES = 1
SECTOR_BYTES = 32


def least_bytes(queries, visits):
    return queries * (KEY_BYTES + ANSWER_BYTES) + visits * SECTOR_BYTES


def read(run):
    if run.op != "probe" or run.trace is None or "probe_visits" not in run.counters:
        return None
    device_s = run.trace.device_s("probe")
    if device_s <= 0:
        return None
    queries = sum(c.keys for c in run.record.calls)
    return 100 * least_bytes(queries, run.counters["probe_visits"]) / HBM_BYTES_PER_S / device_s
