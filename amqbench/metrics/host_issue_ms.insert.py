"""Mean host milliseconds from an insert call's entry to its return: the
façade and the families issuing the work (and waiting, where they read
the card)."""


def read(run):
    if run.op != "insert" or run.trace is None:
        return None
    calls = run.record.calls
    return sum(c.host_s for c in calls) / len(calls) * 1e3
