"""The 95th percentile of every insert call's latency in the window, ms.

A call's latency runs from its issue on the host to the completion of
the CUDA event recorded after it.  The percentile is over all calls,
by the nearest rank: the smallest latency that at least 95% of the
calls do not exceed.
"""

import math

Q = 0.95


def nearest_rank(values, q):
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def read(run):
    if run.op != "insert" or not run.record.calls:
        return None
    lat = [d - c.issue_s for c, d in zip(run.record.calls, run.record.done_s)]
    return nearest_rank(lat, Q) * 1e3
