"""Milliseconds of the host's time an optimizer step, without its wait for
the device: the mean self time of the window's ``train.optimizer`` spans
(the step's duration less its ``train.optimizer.sync`` child, the clip's
read-back of the global norm; ddpo_torch/utils/profiling.py). That leaves
the host's enqueue of the norm's reductions and of the per-leaf update.
None where the program records no such span."""

from ddpo_torch.utils import profiling


def read(run):
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    window = recorded(since=run.start)
    steps = [s for s in window if s.name == "train.optimizer"]
    if not steps:
        return None
    return 1e3 * sum(profiling.self_seconds(s, window) for s in steps) / len(steps)
