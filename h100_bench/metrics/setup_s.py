"""Seconds from the process's start to the window: imports, the kernel
library's load or build, the models and their weights, the warm-up epoch."""


def read(run):
    return run.setup_s
