"""The least time the window's inserts could take on the card's memory
over the device time launched in its insert spans, %.

An insert must read each key once (4 bytes) and read and write the
32-byte sector its fingerprint lands in (64 bytes): 68 bytes a key,
whatever layout or kernel does the work, at the HBM's 3.35 TB/s.
"""

from amqbench.harness.metrics import HBM_BYTES_PER_S

KEY_BYTES = 4
SECTOR_BYTES = 32


def least_bytes(keys):
    return keys * (KEY_BYTES + 2 * SECTOR_BYTES)


def read(run):
    if run.op != "insert" or run.trace is None:
        return None
    device_s = run.trace.device_s("insert")
    if device_s <= 0:
        return None
    keys = sum(c.keys for c in run.record.calls)
    return 100 * least_bytes(keys) / HBM_BYTES_PER_S / device_s
