"""The share of the tap-GEMM's weight-operand lookups that found the
operand made already, in percent: 100 (lookups - misses) / lookups of the
program's ``operand_cache`` (ddpo_torch/ops/conv.py). The counter runs from
the process's start, so the warm-up epoch is counted with the window's:
every epoch makes the same lookups and misses (the sampler lays each conv
weight out once after the refresh writes it, the trainer at each call on
its fresh cast), so each gives the same share. None where the program has
no such counter or made no lookup."""

from ddpo_torch.ops import conv


def read(run):
    counts = getattr(conv, "operand_cache", None)
    if not counts or not counts["lookups"]:
        return None
    return 100.0 * (counts["lookups"] - counts["misses"]) / counts["lookups"]
