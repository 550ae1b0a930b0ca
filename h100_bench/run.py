#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the program.
The cell's entry there names its configuration and traffic; the driver the
traffic names (``drivers/<driver>.py``) runs the set-up and the window, the
check of the same name (``checks/<driver>.py``) compares the first epoch with
the plain reference, and each metric is read by ``metrics/<name>.py``. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with ``--trace 1`` the breakdown, and last the
checks, each number compared beside its limit (also the last lines of
standard error).

It exits non-zero with no result when the card is missing or short of
chips, when the program is missing, and when a JAX module is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddpo_tpu")
# build and kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def set_environment(root: str = ROOT) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, "build", "bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if root not in sys.path:
        sys.path.insert(0, root)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic,
    limits and metrics loaded."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (known: {sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "name": name, "chips": cell["chips"],
        "model": load_json(os.path.join(ROOT, config["file"])),
        "traffic": load_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(BENCH, "limits", name + ".json"))["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def load_module(kind: str, name: str):
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{name}".replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float = T0):
    """The run, its metrics, its checks and whether it is correct."""
    import torch

    driver = cell["traffic"]["driver"]
    run = load_module("drivers", driver).run(cell, seed, seconds, device, trace, t0)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = load_module("checks", driver)
    start = time.perf_counter()
    values = check.readings(cell, seed, run.record, device)["program"]
    run.check_s = time.perf_counter() - start
    checks = check.compare(values, cell["limits"])
    correct = all(value <= limit for _, value, limit in checks)
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": run.peak_bytes}
    if trace and run.trace is not None:
        info.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    return run, metrics, checks, correct, info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_environment()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    run, metrics, checks, correct, info = measure(cell, args.seed, args.seconds,
                                                  bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 4
    print(f"[ h100_bench ] {args.workload} seed {args.seed}: set-up {run.setup_s:.3f} s, "
          f"{run.epochs} epochs in {run.window_s:.3f} s, check {run.check_s:.3f} s, "
          f"peak {run.peak_bytes / 2**30:.2f} GiB; set-up parts (s) "
          f"{json.dumps(run.setup_parts)}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(run, metrics, checks, correct, info, bool(args.trace))),
          flush=True)
    return 0


def result_line(run, metrics: dict, checks: list, correct: bool, info: dict,
                trace: bool) -> dict:
    """The result's keys in order, the checks last."""
    line = {"correct": correct, "attempted": run.epochs, "failed": 0, "metrics": metrics,
            "device": info}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return line


if __name__ == "__main__":
    sys.exit(main())
