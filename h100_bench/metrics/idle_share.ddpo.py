"""The share of the window in which no kernel ran on the card, in percent:
1 - (union of the device intervals) / the window. From the traced run."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
