"""Milliseconds a trainer apply: the window's spans around
``inner_epoch_resident`` and ``refresh_sampler`` (the optimizer steps
included) over the UNet applies they made."""


def read(run):
    if not run.applies:
        return None
    spent = run.spans.total("train", since=run.start) + run.spans.total("refresh", since=run.start)
    return 1e3 * spent / run.applies
