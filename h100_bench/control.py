#!/usr/bin/env python3
"""Readings that set each limit of a cell's check, several seeds in one process.

    python3 h100_bench/control.py --workload <name> --seeds <n> [<n> ...] [--out <file>]

For each seed: the cell's set-up and its first, recorded epoch (the run's
own, drivers/<driver>.py) at the cell's sizes, then the compared numbers
(checks/<driver>.py) of three sides: the program; the control, the
reference computed in float8 e4m3 in the program's place (the next
precision below the configuration's bf16); and the fault "half of the batch
left out, the mean taken over the rest", planted in the reference in the
program's place. ``--sides`` keeps some of them (``program`` alone reads
sound runs). A step that returns its state unchanged reads 1 in ``grad``,
``grad_diff`` and ``change`` by their definition, and a negated gradient 2
in ``grad_diff``: they need no run. One JSON line a seed and side, on
standard output and appended to ``--out``.

The benchmark's own runs do not run this. It needs the card, as a run does.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import run as harness  # noqa: E402

SIDES = ("program", "fp8", "half_batch")


def control(cell: dict, seeds, device, out=None, sides=SIDES) -> list:
    lines = []
    driver = harness.load_module("drivers", cell["traffic"]["driver"])
    check = harness.load_module("checks", cell["traffic"]["driver"])
    for seed in seeds:
        start = time.perf_counter()
        record = driver.record_first_epoch(cell, seed, device)
        values = check.readings(cell, seed, record, device, sides=sides)
        for side in sides:
            line = {"workload": cell["name"], "seed": seed, "side": side,
                    "seconds": time.perf_counter() - start, "values": values[side]}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--sides", nargs="+", choices=SIDES, default=list(SIDES))
    args = parser.parse_args(argv)
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    control(harness.load_cell(args.workload), args.seeds, "cuda", args.out, tuple(args.sides))
    return 0


if __name__ == "__main__":
    sys.exit(main())
