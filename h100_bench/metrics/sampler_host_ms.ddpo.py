"""Milliseconds of the host's time a sampler step: the mean of the window's
``sampler.step`` spans, which the program records around each denoising
step's CFG UNet call and scheduler step (ddpo_torch/utils/profiling.py).
No span synchronizes, so this is the host's enqueue of the step, with
whatever wait a full launch queue forces on it. None where the program
records no such span."""

from ddpo_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    steps = recorded("sampler.step", since=run.start)
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in steps) / len(steps)
