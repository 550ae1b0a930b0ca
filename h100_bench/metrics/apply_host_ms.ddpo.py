"""Milliseconds of the host's time a trained timestep: the mean of the
window's ``train.apply`` spans, which the program records around each
timestep's loss and backward (ddpo_torch/utils/profiling.py). No span
synchronizes, so this is the host's enqueue of the forward, the remat
recompute and the backward, with whatever wait a full launch queue forces
on it. None where the program records no such span."""

from ddpo_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    applies = recorded("train.apply", since=run.start)
    if not applies:
        return None
    return 1e3 * sum(s.seconds for s in applies) / len(applies)
