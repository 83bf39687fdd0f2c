"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' libraries (built by nvcc on a checkout's first
run), the keys, the set-up fill and the warm-up calls."""


def read(run):
    return run.setup_s
