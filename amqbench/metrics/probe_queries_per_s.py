"""Queries answered in the window over the window's seconds (host clock)."""


def read(run):
    if run.op != "probe":
        return None
    return sum(c.keys for c in run.record.calls) / run.record.window_s
