"""The device memory the window's work held at its peak:
``torch.cuda.max_memory_allocated()`` from the window's start."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
