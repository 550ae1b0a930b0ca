"""Full-train-state checkpoints with torch.save, and the UNet export.

Port of ddpo_tpu/utils/checkpoints.py (save_train_state, restore_train_state,
latest_checkpoint_step, prune_checkpoints, wait_for_pending_saves), with
``torch.save``/``torch.load`` in place of Orbax. Single process.

``save_unet``, ``get_latest_epoch`` and ``load_unet_pickle`` keep the JAX
package's (and the reference's) export format: ``unet_{epoch}.pkl``, a
pickled Flax-layout tree of numpy arrays, written through
``models.convert.to_flax``. So ddpo_tpu's ``load_unet_pickle`` reads the
port's export, and the port reads the JAX package's.

Layout under ``savepath/checkpoints/``:
  <step>/state.pt     the device state (params, optimizer state, counters),
                      written as state.pt.tmp and renamed when complete, so
                      a step directory without state.pt is an unfinished
                      write and is not restored;
  <step>_host.pkl     the host state beside it (RNG states, reward history,
                      per-prompt stat buffers), pickled.

``block=False`` copies every tensor to host memory first, synchronously
(training goes on updating the device tensors in place), then serializes and
writes on a background thread. At most one write is in flight: a new save,
a restore and ``wait_for_pending_saves`` join the previous one, and a failed
write is re-raised at that join.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
import threading
import time
from typing import Any, Mapping, Optional

import torch

from ddpo_torch.utils import filesystem as fs

STATE_FILE = "state.pt"

# in-flight background writes; joined by wait_for_pending_saves()
_PENDING: list = []
_PENDING_ERRORS: list = []
# what the newest finished write took: {"step", "path", "bytes", "copy_s", "write_s"}
last_save: dict = {}


def wait_for_pending_saves() -> None:
    """Block until every background write has landed; re-raise the first
    error one of them hit (a lost checkpoint must not look saved)."""
    while _PENDING:
        _PENDING.pop().join()
    if _PENDING_ERRORS:
        step, err = _PENDING_ERRORS.pop(0)
        _PENDING_ERRORS.clear()
        raise RuntimeError(f"async checkpoint write for step {step} failed") from err


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor in a nested dict/list payload."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _step_dir(savepath: str, step: int) -> str:
    return os.path.abspath(os.path.join(savepath, "checkpoints", str(step)))


def save_train_state(
    savepath: str, step: int, payload: Any, host_state: Any = None,
    block: bool = True,
) -> str:
    """Write one full-state checkpoint under savepath/checkpoints/<step>."""
    wait_for_pending_saves()  # at most one write in flight
    path = _step_dir(savepath, step)
    start = time.perf_counter()
    payload = _to_host(payload)
    copy_s = time.perf_counter() - start

    def _write():
        t0 = time.perf_counter()
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, STATE_FILE)
        torch.save(payload, target + ".tmp")
        os.replace(target + ".tmp", target)
        if host_state is not None:
            with open(f"{path}_host.pkl", "wb") as f:
                pickle.dump(host_state, f)
        last_save.clear()
        last_save.update(step=step, path=path, bytes=os.path.getsize(target),
                         copy_s=copy_s, write_s=time.perf_counter() - t0)

    if block:
        _write()
        return path

    def _write_captured():
        try:
            _write()
        except Exception as e:  # re-raised at the next join
            _PENDING_ERRORS.append((step, e))

    t = threading.Thread(target=_write_captured, daemon=False, name=f"ckpt-{step}")
    t.start()
    _PENDING.append(t)
    return path


def _complete_steps(root: str):
    if not os.path.isdir(root):
        return []
    return sorted(
        int(d) for d in os.listdir(root)
        if d.isdigit() and os.path.exists(os.path.join(root, d, STATE_FILE))
    )


def latest_checkpoint_step(savepath: str) -> Optional[int]:
    wait_for_pending_saves()
    steps = _complete_steps(os.path.join(savepath, "checkpoints"))
    return steps[-1] if steps else None


def prune_checkpoints(savepath: str, keep: int) -> int:
    """Delete all but the newest ``keep`` checkpoints; returns the count
    removed. keep <= 0 disables pruning. Joins in-flight writes first."""
    if keep <= 0:
        return 0
    wait_for_pending_saves()
    root = os.path.join(savepath, "checkpoints")
    steps = sorted(int(d) for d in os.listdir(root) if d.isdigit()) if os.path.isdir(root) else []
    removed = 0
    for step in steps[:-keep] if keep < len(steps) else []:
        shutil.rmtree(os.path.join(root, str(step)), ignore_errors=True)
        for host in glob.glob(os.path.join(root, f"{step}_host*.pkl")):
            os.remove(host)
        removed += 1
    return removed


def restore_train_state(savepath: str, step: Optional[int] = None,
                        map_location: Any = "cpu"):
    """Restore the newest (or given) checkpoint -> (payload, step), or
    (None, None) if there is none. The host state, if saved, is merged into
    the payload under "host"."""
    wait_for_pending_saves()
    if step is None:
        step = latest_checkpoint_step(savepath)
        if step is None:
            return None, None
    path = _step_dir(savepath, step)
    restored = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                          weights_only=True)
    if os.path.exists(f"{path}_host.pkl"):
        with open(f"{path}_host.pkl", "rb") as f:
            restored = dict(restored, host=pickle.load(f))
    return restored, step


# ---------------- reference-format UNet artifacts ---------------- #


def save_unet(savepath: str, unet: torch.nn.Module, epoch: int = 0,
              params: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Pickle the UNet's parameters as savepath/unet_{epoch}.pkl in the Flax
    layout; ``params`` (a state mapping of ``unet``, e.g. a LoRA merge)
    defaults to ``unet.state_dict()``. Returns the file's path."""
    from ddpo_torch.models.convert import to_flax

    os.makedirs(savepath, exist_ok=True)
    fullpath = os.path.join(savepath, f"unet_{epoch}.pkl")
    tree = to_flax(unet.state_dict() if params is None else params, unet)
    with open(fullpath + ".tmp", "wb") as f:
        pickle.dump(tree, f)
    os.replace(fullpath + ".tmp", fullpath)
    return fullpath


def get_latest_epoch(loadpath: str) -> int:
    """Largest N among unet_N.pkl files under loadpath."""
    fnames = [f for f in fs.ls(loadpath) if f.startswith("unet_") and f.endswith(".pkl")]
    if not fnames:
        raise FileNotFoundError(f"no unet_*.pkl under {loadpath}")
    return max(int(f.split("_")[-1].split(".pkl")[0]) for f in fnames)


def load_unet_pickle(loadpath: str, epoch="latest") -> dict:
    """The Flax-layout UNet tree of loadpath/unet_{epoch}.pkl."""
    if epoch == "latest":
        epoch = get_latest_epoch(loadpath)
    return fs.unpickle(os.path.join(loadpath, f"unet_{epoch}.pkl"))
