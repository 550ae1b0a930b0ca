"""Structured metrics export: append-only JSONL scalar stream per run.

The reference has no metrics system beyond per-epoch .npy dumps and a
matplotlib curve (SURVEY.md 5.5: "No W&B/TensorBoard" — reference
pipeline/policy_gradient.py:339-369, 466-477). This module adds the
observability layer a production deployment needs without adding any
dependency: every driver appends one JSON object per logical step to
``metrics.jsonl`` under the run's savepath. The format is line-delimited
JSON so it is tail-able mid-run, trivially greppable, and loads into
pandas/W&B/BigQuery with one call.

Schema (one line per event):
    {"step": int, "wall_time": float-unix-seconds, "<scalar>": float, ...}

Only process 0 writes (callers pass ``enabled=worker_id == 0``). Values are
coerced to plain Python floats/ints/strs; numpy scalars and 0-d tensors
are accepted. If ``DDPO_TPU_WANDB=1`` and wandb is importable, events are
mirrored to an active wandb run (never initialized here — the caller owns
wandb.init); absence of wandb is silent.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List


def _coerce(value: Any):
    """Best-effort conversion of a logged value to a JSON-native scalar."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    # reject arrays of ANY positive rank — including shape-(1,): item()
    # would silently accept those and then crash when the batch size
    # changes; callers should reduce with .mean()/.item() explicitly
    if getattr(value, "ndim", 0) != 0:
        raise TypeError(
            f"metrics values must be scalars; got {type(value).__name__} "
            f"of shape {getattr(value, 'shape', '?')} (reduce arrays with "
            ".mean()/.item() before logging)"
        )
    # numpy scalars / 0-d arrays / 0-d tensors all expose item()
    item = getattr(value, "item", None)
    if item is not None:
        try:
            return item()
        except (TypeError, ValueError):
            pass
    raise TypeError(
        f"metrics values must be scalars; got {type(value).__name__} "
        f"(reduce arrays with .mean()/.item() before logging)"
    )


def run_dir(savepath: str) -> str:
    """Local directory for a run's metrics stream (sample/finetune/calibrate).

    These drivers log next to their own artifacts: in savepath itself when
    local, in the "logs/<bucket path>" local mirror when remote. (The PG
    driver is intentionally different — it mirrors ALL artifacts under
    logs/ even for local savepaths, reference layout — and keeps its own
    localpath expression.) One definition for the three RWR-side drivers so
    their streams never diverge.
    """
    if savepath.startswith("gs://"):
        return "logs/" + savepath[len("gs://"):]
    return savepath


class MetricsLogger:
    """Append-only JSONL scalar logger for one run.

    Usage:
        metrics = MetricsLogger(localpath, enabled=worker_id == 0)
        metrics.log(step=epoch, phase="sample", mean_reward=r.mean())
    """

    FILENAME = "metrics.jsonl"

    def __init__(self, savedir: str, enabled: bool = True, filename: str = None):
        self.enabled = enabled
        self.path = os.path.join(savedir, filename or self.FILENAME)
        self._wandb = None
        if enabled and os.environ.get("DDPO_TPU_WANDB") == "1":
            try:  # pragma: no cover - wandb not installed in CI
                import wandb

                if wandb.run is not None:
                    self._wandb = wandb
            except ImportError:
                pass

    def log(self, step: int, **scalars) -> None:
        if not self.enabled:
            return
        event: Dict[str, Any] = {"step": int(step), "wall_time": time.time()}
        for key, value in scalars.items():
            event[key] = _coerce(value)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log({k: v for k, v in event.items() if k != "step"}, step=step)


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Load a metrics.jsonl file (or its directory) back into a list of events."""
    if os.path.isdir(path):
        path = os.path.join(path, MetricsLogger.FILENAME)
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def iter_scalar(events: List[Dict[str, Any]], key: str) -> Iterator[tuple]:
    """Yield (step, value) pairs for one scalar across events that carry it."""
    for event in events:
        if key in event:
            yield event["step"], event[key]
