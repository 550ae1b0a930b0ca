"""Seconds of wall time a DDPO epoch, over the window's whole epochs."""


def read(run):
    return run.window_s / run.epochs
