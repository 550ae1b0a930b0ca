"""The window's peak of allocated device memory, in GiB
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
