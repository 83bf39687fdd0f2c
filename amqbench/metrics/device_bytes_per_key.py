"""The window's peak of device memory over the configuration's design
capacity in keys: ``torch.cuda.max_memory_allocated()``, reset when the
window opens, over ``max_load`` times the buckets of every quotient
filter in it."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / run.capacity_keys
