"""The port's host utilities and its RWR drivers under two ranks, on the CPU.

  - ``utils/progress.py``: ``Progress`` and ``Silent`` print what ddpo_tpu's
    print for the same calls (one clock for both, stdout not a TTY);
  - ``--profile_dir`` writes a torch.profiler trace of epoch 1 (start
    epoch + 1, as JAX) and none of epoch 0;
  - ``utils/profiling.py``'s ``process_seconds`` (this process's age, from
    /proc) and ``launch_timeline`` (a run's seconds that add up, with the
    exit's parts timed as the DDPO driver's or untimed as sp_check's);
  - two ranks (``ddpo_torch.parallel.launch``, gloo) of ``sample``: each
    writes its own ``-w{rank}-`` split files, with different samples, and
    both count the global number of samples; then ``calibrate``: its curve's
    ``n`` is the count over both ranks, and rank 0 alone writes the files.
"""

import contextlib
import io
import json
import os
import sys
import time

import h5py
import numpy as np
import pytest
import torch

from ddpo_torch.parallel.launch import launch
from ddpo_torch.utils import progress as t_progress
from ddpo_tpu.utils import progress as j_progress
from test_torch_pipeline import COMMON, workdir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(module, monkeypatch):
    clock = iter(np.arange(0.0, 1000.0, 0.25))
    monkeypatch.setattr(module.time, "time", lambda: float(next(clock)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        p = module.Progress(5, name="epoch 0", speed_update_freq=2)
        for i in range(5):
            p({"loss": 1e-5 * (i + 1), "idx_max": i, "cfg": True})
        p.append_description("done")
        p.stamp()
        p.pause()
        p.resume()
        p.set_description([("kl", 3.0e-7)])
        p.close()
        s = module.Silent(5, name="quiet")
        s({"loss": 1.0})
        s.stamp()
        s.anything_at_all(1, 2)
    return out.getvalue()


def test_progress_and_silent_match_jax(monkeypatch):
    got, want = _drive(t_progress, monkeypatch), _drive(j_progress, monkeypatch)
    assert got == want
    assert "[ epoch 0 ] 5 / 5" in got and "loss : 5.00e-05" in got


def test_process_seconds():
    from ddpo_torch.utils.profiling import process_seconds

    age = process_seconds()
    if age is None:  # no /proc
        return
    assert 0 < age < 24 * 3600
    assert process_seconds() >= age


@pytest.mark.parametrize("timed_exit", [True, False])
def test_launch_timeline_adds_up(timed_exit):
    from ddpo_torch.utils.profiling import StepTimer, launch_timeline

    boot, leave = StepTimer(), StepTimer()
    entered = time.perf_counter()
    with boot.phase("models"):
        time.sleep(0.02)
    start = time.perf_counter()
    time.sleep(0.02)
    end = time.perf_counter()
    with leave.phase("checkpoint_copy"):
        time.sleep(0.02)
    t = launch_timeline(entered, 1.5, boot, start, end, leave if timed_exit else None)
    assert t["before_main"] == 1.5 and t["work"] >= 0.02
    assert t["startup"]["models"] >= 0.02
    assert ("checkpoint_copy" in t["exit"]) == timed_exit and t["exit"]["rest"] >= 0
    if timed_exit:
        assert t["exit"]["checkpoint_copy"] >= 0.02
    else:  # the untimed exit is all rest
        assert t["exit"]["rest"] >= 0.02
    assert t["main_to_work"] == pytest.approx(sum(t["startup"].values()), abs=1e-3)
    assert t["exit_to_return"] == pytest.approx(sum(t["exit"].values()), abs=1e-3)
    assert abs(t["returned_at"] - time.time()) < 5


def test_profile_dir_traces_epoch_1(workdir):  # noqa: F811
    from ddpo_torch.pipelines import policy_gradient

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        policy_gradient.main(COMMON + ["--num_train_epochs", "2", "--profile_dir", "prof"])
    finally:
        torch.set_num_threads(n)
    assert sorted(os.listdir(workdir / "prof")) == ["epoch1_rank0.json"]
    trace = json.loads((workdir / "prof" / "epoch1_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in name for name in names)  # the UNet's ops were recorded


WORKER = r'''
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.parallel import maybe_initialize_distributed, process_index
from ddpo_torch.pipelines import calibrate, sample

maybe_initialize_distributed()
rank = process_index()
common = ["--dataset", "debug-animals", "--device", "cpu", "--resolution", "32",
          "--n_inference_steps", "2"]
n = sample.main(common + ["--max_samples", "4", "--n_samples_per_device", "1",
                          "--local_size", "8"])
result = calibrate.main(common + ["--n_eval_batches", "2", "--savepath", "calib"])
with open(f"ranks_{rank}.json", "w") as f:
    json.dump({"n_samples": n, "curve": {str(k): v for k, v in result.curve.items()},
               "renderer": result.renderer}, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rwr_ranks")
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", DDPO_BUCKET="bucket")
    results = launch([sys.executable, str(tmp / "worker.py")], 2, timeout=240, env=env,
                     cwd=str(tmp))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return tmp, [json.loads((tmp / f"ranks_{r}.json").read_text()) for r in range(2)]


def test_two_rank_sample_writes_per_rank_files(two_ranks):
    tmp, ranks = two_ranks
    assert [r["n_samples"] for r in ranks] == [4, 4]  # the global count, on both
    samples = tmp / "bucket" / "logs" / "debug-animals" / "samples" / "0"
    files = sorted(f for f in os.listdir(samples) if f.endswith(".hdf5"))
    by_rank = {w: [f for f in files if f"-w{w}-" in f] for w in (0, 1)}
    assert len(by_rank[0]) == 1 and len(by_rank[1]) == 1 and len(files) == 2
    images = {}
    for w, (name,) in by_rank.items():
        with h5py.File(samples / name, "r") as f:
            images[w] = np.asarray(f["images"][:])
    assert len(images[0]) == len(images[1]) == 2  # each rank wrote half
    assert not any(np.array_equal(a, b) for a in images[0] for b in images[1])


def test_two_rank_calibrate_counts_both_ranks(two_ranks):
    tmp, ranks = two_ranks
    assert ranks[0]["curve"] == ranks[1]["curve"]
    assert {v["n"] for v in ranks[0]["curve"].values()} == {4}  # 2 batches x 1 x 2 ranks
    assert ranks[0]["renderer"] in ("matplotlib", "pil") and ranks[1]["renderer"] is None
    written = json.loads((tmp / "bucket" / "logs" / "debug-animals" / "calib"
                          / "calibration.json").read_text())
    assert {v["n"] for v in written["curve"].values()} == {4}
