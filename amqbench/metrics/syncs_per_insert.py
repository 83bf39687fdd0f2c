"""Synchronizations with the card an insert call makes: the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` inside the insert spans of
the traced run, over the insert calls."""


def read(run):
    if run.op != "insert" or run.trace is None or "insert" not in run.trace.syncs:
        return None
    return run.trace.syncs["insert"] / len(run.record.calls)
