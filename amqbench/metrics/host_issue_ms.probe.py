"""Mean host milliseconds from a ``contains`` call's entry to its return."""


def read(run):
    if run.op != "probe" or run.trace is None:
        return None
    calls = run.record.calls
    return sum(c.host_s for c in calls) / len(calls) * 1e3
