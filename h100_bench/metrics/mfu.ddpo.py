"""The whole window's share of the card's bf16 dense peak: the model
operations of its epochs (work.py ``EpochWork``) over the window's time
times 989 TFLOP/s, in percent."""

from h100_bench.work import PEAK_BF16_FLOPS


def read(run):
    return 100.0 * run.work.flops * run.epochs / (run.window_s * PEAK_BF16_FLOPS)
