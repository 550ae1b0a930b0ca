"""RWR outer loop: sample -> sizes -> sample -> sizes -> finetune, iterated.

Port of ddpo_tpu/pipelines/rwr_loop.py (the reference's pipeline/run-rwr.sh
and run-sparse.sh as one Python driver). Per iteration i:

  1. collect an unfiltered evaluation set into samples/{i}_reference,
  2. build its sizes.pkl manifest,
  3. collect the filtered/weighted finetuning set into samples/{i},
  4. build its manifest,
  5. finetune models/{i} -> models/{i+1} on it,

then a final evaluation sample from the last model. Iteration-scoped paths
come from the same "f:" lazy config fields, so any iteration can be re-run
by hand. ``--device`` (the port's own key) goes to the sampling and
finetuning drivers.

Run: python -m ddpo_torch.pipelines.rwr_loop --dataset compressed-animals-rwr \
         --iterations 10 [--sparse]
"""

from __future__ import annotations

import argparse

from ddpo_torch.pipelines import finetune, sample, save_sizes


def run_iteration(dataset: str, iteration: int, eval_samples: int = 10000,
                  device: str = "cuda") -> None:
    common = ["--dataset", dataset, "--iteration", str(iteration)]
    on_device = ["--device", device]

    # 1-2. unfiltered evaluation set + manifest
    sample.main(
        common + on_device
        + [
            "--max_samples", str(eval_samples),
            "--mask_param", "0",
            "--evaluate", "True",
            "--identical_batch", "False",
            "--savepath", f"samples/{iteration}_reference",
        ]
    )
    save_sizes.main(common + ["--loadpath", f"samples/{iteration}_reference"])

    # 3-4. finetuning set + manifest
    sample.main(common + on_device)
    save_sizes.main(list(common))

    # 5. finetune into models/{iteration+1}
    finetune.main(common + on_device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--dataset", default="compressed_animals_rwr")
    ap.add_argument(
        "--sparse",
        action="store_true",
        help="sparse filtering variant (reference run-sparse.sh): use the "
        "percentile-masked dataset config instead of the keep-all *_rwr one "
        "(drops a -rwr/_rwr suffix from --dataset if present)",
    )
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--eval_samples", type=int, default=10000)
    ap.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    args, _ = ap.parse_known_args(argv)

    if args.sparse:
        for suffix in ("_rwr", "-rwr"):
            if args.dataset.endswith(suffix):
                args.dataset = args.dataset[: -len(suffix)]
                break

    for i in range(args.iterations):
        print(f"[ rwr_loop ] ======== iteration {i} ========")
        run_iteration(args.dataset, i, args.eval_samples, args.device)

    # final evaluation sample from the last model
    final = args.iterations
    sample.main(
        [
            "--dataset", args.dataset,
            "--iteration", str(final),
            "--max_samples", str(args.eval_samples),
            "--mask_param", "0",
            "--evaluate", "True",
            "--savepath", f"samples/{final}_reference",
            "--device", args.device,
        ]
    )
    save_sizes.main(
        ["--dataset", args.dataset, "--iteration", str(final),
         "--loadpath", f"samples/{final}_reference"]
    )


if __name__ == "__main__":
    main()
