"""Two-rank preemption of the port's DDPO driver: SIGTERM in epoch 1, resume.

The port of tests/test_multiprocess_preemption.py, on the CPU with gloo
(``ddpo_torch.parallel.launch``: a free port, each rank's own timeout,
``destroy_process_group`` at the end). Rank 1 alone SIGTERMs itself at
epoch 1's prompt generation; the ranks agree at the epoch boundary to stop,
so both checkpoint epoch 1 (rank 0 the state, each rank its own host
pickle) and exit. A two-rank ``--resume`` then runs epoch 2, and:

  - its reward curve and train losses equal an uninterrupted two-rank
    run's (rtol 1e-6 and 1e-5, as the single-process resume test holds);
  - both ranks restore the same state (digest of the restored tree);
  - the per-rank host pickles exist, and each rank restored its own
    (their sampler generator states differ).
"""

import json
import os
import sys

import numpy as np

from ddpo_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = ("bucket", "logs", "debug-animals", "models", "pg", "checkpoints")
LOGDIR = ("logs", "bucket", "logs", "debug-animals", "models", "pg")

WORKER = r'''
import json, os, signal, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch import training
from ddpo_torch.parallel import digest, maybe_initialize_distributed, process_index
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.utils.checkpoints import restore_train_state

maybe_initialize_distributed()
rank, mode = process_index(), sys.argv[1]
out = {}
if mode == "preempt" and rank == 1:
    real_make_prompts = training.make_prompts
    calls = {"n": 0}

    def sigterm_on_second_call(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # epoch 1's first sample batch
            os.kill(os.getpid(), signal.SIGTERM)
        return real_make_prompts(*a, **kw)

    training.make_prompts = sigterm_on_second_call
if mode == "resume":
    restored, step = restore_train_state("bucket/logs/debug-animals/models/pg")
    out["restored_step"] = step
    out["restored_digest"] = digest(restored["state"])
    out["sample_generator"] = digest(restored["host"]["sample_generator"])
argv = ["--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
        "--save_freq", "1", "--per_prompt_stats_bufsize", "8",
        "--per_prompt_stats_min_count", "2", "--num_train_epochs", "3"]
out["rewards"] = policy_gradient.main(argv + (["--resume", "True"] if mode == "resume" else []))
with open(f"{mode}_{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _run(workdir, mode):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", DDPO_BUCKET="bucket")
    script = workdir / "worker.py"
    script.write_text(WORKER)
    results = launch([sys.executable, str(script), mode], 2, timeout=240, env=env,
                     cwd=str(workdir))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"{mode} rank {rank} failed:\n{out[-4000:]}"
    return [json.loads((workdir / f"{mode}_{r}.json").read_text()) for r in range(2)], \
        [out for _, out in results]


def _losses(workdir):
    logdir = workdir.joinpath(*LOGDIR, "train_info")
    return {f.name: np.load(f, allow_pickle=True).item()["loss"] for f in sorted(logdir.iterdir())}


def test_two_rank_preemption_resumes_like_an_uninterrupted_run(tmp_path):
    full_dir, run_dir = tmp_path / "full", tmp_path / "preempted"
    full_dir.mkdir()
    run_dir.mkdir()
    full, _ = _run(full_dir, "full")
    preempted, logs = _run(run_dir, "preempt")

    # both ranks stopped after epoch 1 (rank 0 never got the signal)
    assert [len(p["rewards"]) for p in preempted] == [2, 2]
    assert "SIGTERM" in logs[1] and "graceful shutdown after epoch 1" in logs[0]
    ckpt = run_dir.joinpath(*CKPT)
    assert (ckpt / "1" / "state.pt").exists()
    assert (ckpt / "1_host.pkl").exists() and (ckpt / "1_host_p1.pkl").exists()

    resumed, logs = _run(run_dir, "resume")
    assert all("resumed from checkpoint at epoch 1" in log for log in logs)
    assert [r["restored_step"] for r in resumed] == [1, 1]
    assert resumed[0]["restored_digest"] == resumed[1]["restored_digest"]
    assert resumed[0]["sample_generator"] != resumed[1]["sample_generator"]
    for r in resumed + full:
        assert len(r["rewards"]) == 3
    np.testing.assert_allclose(resumed[0]["rewards"], full[0]["rewards"], rtol=1e-6)
    assert resumed[0]["rewards"] == resumed[1]["rewards"]

    losses_full, losses_resumed = _losses(full_dir), _losses(run_dir)
    assert set(losses_full) == set(losses_resumed) == {f"0_{e}_0.npy" for e in range(3)}
    for name, loss in losses_full.items():
        np.testing.assert_allclose(losses_resumed[name], loss, rtol=1e-5, err_msg=name)
