"""Full-train-state checkpoints with torch.save, and the UNet export.

Port of ddpo_tpu/utils/checkpoints.py (save_train_state, restore_train_state,
latest_checkpoint_step, prune_checkpoints, wait_for_pending_saves), with
``torch.save``/``torch.load`` in place of Orbax.

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
                      per-prompt stat buffers), pickled; rank r > 0 writes
                      its own as <step>_host_p<r>.pkl.

More than one process: the state is the same on every rank (the caller
checks a digest), so rank 0 writes state.pt, and every rank writes its own
host pickle (ddpo_tpu/utils/checkpoints.py:111-134) and restores its own.
The ranks then share the directory; on several hosts it is a shared
filesystem, or a bucket the driver syncs (pipelines/policy_gradient.py).

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

from ddpo_torch.parallel.collectives import process_index
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


def host_file(step_dir: str, rank: Optional[int] = None) -> str:
    """The host pickle of ``rank`` (default: this process) beside a step
    directory: <step>_host.pkl for rank 0, <step>_host_p<r>.pkl else."""
    rank = process_index() if rank is None else rank
    return f"{step_dir}_host.pkl" if rank == 0 else f"{step_dir}_host_p{rank}.pkl"


def save_train_state(
    savepath: str, step: int, payload: Any, host_state: Any = None,
    block: bool = True,
) -> str:
    """Write one full-state checkpoint under savepath/checkpoints/<step>:
    the state on rank 0, this rank's host state on every rank."""
    wait_for_pending_saves()  # at most one write in flight
    path = _step_dir(savepath, step)
    writer = process_index() == 0
    start = time.perf_counter()
    payload = _to_host(payload) if writer else None
    copy_s = time.perf_counter() - start

    def _write():
        t0 = time.perf_counter()
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, STATE_FILE)
        if writer:
            torch.save(payload, target + ".tmp")
            os.replace(target + ".tmp", target)
        if host_state is not None:
            with open(host_file(path), "wb") as f:
                pickle.dump(host_state, f)
        last_save.clear()
        last_save.update(step=step, path=path,
                         bytes=os.path.getsize(target) if writer else 0,
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
    (None, None) if there is none. This rank's host state, if saved, is
    merged into the payload under "host"; a rank r > 0 whose own pickle is
    missing beside rank 0's raises (its RNG streams were never saved, and
    taking rank 0's would repeat rank 0's draws)."""
    wait_for_pending_saves()
    if step is None:
        step = latest_checkpoint_step(savepath)
        if step is None:
            return None, None
    path = _step_dir(savepath, step)
    restored = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                          weights_only=True)
    own = host_file(path)
    if os.path.exists(own):
        with open(own, "rb") as f:
            restored = dict(restored, host=pickle.load(f))
    elif os.path.exists(host_file(path, 0)):
        raise FileNotFoundError(f"{own} is missing beside {host_file(path, 0)}: "
                                "this rank's host state was not saved")
    return restored, step


# ---------------- reference-format UNet artifacts ---------------- #


def save_unet(savepath: str, unet: torch.nn.Module, epoch: int = 0,
              params: Optional[Mapping[str, torch.Tensor]] = None,
              cache: str = "logs") -> str:
    """Pickle the UNet's parameters as savepath/unet_{epoch}.pkl in the Flax
    layout; ``params`` (a state mapping of ``unet``, e.g. a LoRA merge)
    defaults to ``unet.state_dict()``. A gs:// savepath is written to a
    local copy under ``cache``/<bucket path> and then to the bucket
    (ddpo_tpu/utils/checkpoints.py:234-252). Rank 0 writes (the parameters
    are the same on every rank). Returns the local file's path."""
    from ddpo_torch.models.convert import to_flax

    remote = fs.is_remote(savepath)
    local = os.path.join(cache, savepath.replace("gs://", "")) if remote else savepath
    fullpath = os.path.join(local, f"unet_{epoch}.pkl")
    if process_index() != 0:
        return fullpath
    os.makedirs(local, exist_ok=True)
    tree = to_flax(unet.state_dict() if params is None else params, unet)
    with open(fullpath + ".tmp", "wb") as f:
        pickle.dump(tree, f)
    os.replace(fullpath + ".tmp", fullpath)
    if remote:
        fs.put_file(fullpath, os.path.join(savepath, f"unet_{epoch}.pkl"))
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
