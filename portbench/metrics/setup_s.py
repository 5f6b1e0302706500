"""Seconds from the process's start to the window's: torch and the CUDA
context, the pool written, the kernels loaded (or built, on a checkout's
first run) and one warm batch over each shape of the pool."""


def read(run):
    return run.setup_s
