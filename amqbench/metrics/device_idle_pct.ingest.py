"""Share of the traced ingest window in which no device operation runs, %."""


def read(run):
    if run.op != "insert" or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
