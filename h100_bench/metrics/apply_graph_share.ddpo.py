"""The share of the trainer's UNet applies that replayed CUDA graphs captured
before, in percent: 100 replays / (captures + replays + eager applies) of
the program's ``train_graphs`` counter (ddpo_torch/pipelines/
policy_gradient.py ``make_train_apply``). The counter runs from the
process's start, so the warm-up epoch is counted with the window's: its
first apply runs eagerly (the kernels' warm-up) and its second captures.
None where the program has no such counter or made no apply."""

from ddpo_torch.pipelines import policy_gradient


def read(run):
    counts = getattr(policy_gradient, "train_graphs", None)
    if not counts or not sum(counts.values()):
        return None
    return 100.0 * counts["replays"] / sum(counts.values())
