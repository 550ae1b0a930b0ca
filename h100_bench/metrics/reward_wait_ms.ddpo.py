"""Milliseconds an epoch waits on the reward's future after the decode."""


def read(run):
    return 1e3 * run.spans.total("reward_wait", since=run.start) / run.epochs
