"""Milliseconds a sampler step: the window's spans around
``sample_trajectories`` (each ending in a synchronize) over its steps."""


def read(run):
    if not run.sampler_steps:
        return None
    return 1e3 * run.spans.total("sampler", since=run.start) / run.sampler_steps
