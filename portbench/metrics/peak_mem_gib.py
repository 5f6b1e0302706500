"""Peak device memory the program allocated in the window, in GiB, on
the fullest card (``torch.cuda.max_memory_allocated``, reset at the
window's start)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
