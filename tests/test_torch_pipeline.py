"""The port's DDPO pipeline end to end on the CPU (debug-animals, tiny preset).

What the JAX package's pipeline tests hold, at a size that runs unmarked:
the arange reward's mean over a batch of 8 is 3.5; the first minibatch is
on-policy (the trainer recomputes the sampler's log-probs: approx_kl below
1e-6, measured 1.6e-12 with train batch 1 against sample batch 8); every
artifact and a full checkpoint are written; a resumed run gives the
uninterrupted run's rewards and train losses (rtol 1e-6 and 1e-5, as
tests/test_resume_and_sync.py holds the JAX pipeline); SIGTERM checkpoints at
the epoch boundary and exits.
"""

import importlib
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

LOGDIR = ("logs", "bucket", "logs", "debug-animals", "models", "pg")
CKPT_ROOT = ("bucket", "logs", "debug-animals", "models", "pg")

COMMON = [
    "--dataset", "debug-animals", "--device", "cpu",
    "--n_inference_steps", "2",
    "--resolution", "32",
    "--sample_batch_size", "2",
    "--train_batch_size", "1",
    "--save_freq", "1",
    # per-prompt stats on, so the tracker's buffers matter for advantages
    "--per_prompt_stats_bufsize", "8",
    "--per_prompt_stats_min_count", "2",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and the
    suite runs several workers at once, where spinning OpenMP threads
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    import ddpo_torch.config.base as base
    import ddpo_torch.config.user as user

    importlib.reload(user)
    importlib.reload(base)
    yield tmp_path
    monkeypatch.undo()
    importlib.reload(user)
    importlib.reload(base)


def _train_infos(logdir):
    return {f.name: np.load(f, allow_pickle=True).item()
            for f in sorted((logdir / "train_info").iterdir())}


@pytest.mark.parametrize("fused", ["True", "False"])
def test_pipeline_end_to_end(workdir, fused):
    from ddpo_torch.pipelines import policy_gradient

    rewards = policy_gradient.main([
        "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "8", "--num_train_epochs", "1",
        "--fused_train_loop", fused,
    ])
    assert rewards == [3.5]  # arange over a batch of 8
    logdir = workdir.joinpath(*LOGDIR)
    info = _train_infos(logdir)["0_0_0.npy"]
    # fused: one info per minibatch (8); unfused: one per (minibatch, timestep)
    assert info["approx_kl"].shape == ((8,) if fused == "True" else (16,))
    first = info["approx_kl"][: 1 if fused == "True" else 2]
    assert np.all(first < 1e-6), first  # on-policy until the first update
    assert np.isfinite(info["loss"]).all() and np.isfinite(info["clipfrac"]).all()
    for sub in ("rewards", "prompts", "callback_info", "train_info", "samples"):
        assert any((logdir / sub).iterdir()), sub
    assert (logdir / "metrics.jsonl").exists()
    curve = json.loads((logdir / "reward_curve.json").read_text())
    assert curve["mean"] == [3.5]
    ckpt = workdir.joinpath(*CKPT_ROOT, "checkpoints")
    assert (ckpt / "0" / "state.pt").exists() and (ckpt / "0_host.pkl").exists()
    state = torch.load(ckpt / "0" / "state.pt", weights_only=True)
    assert state["epoch"] == 0 and state["state"]["opt_state"]["count"] == 8
    mu = next(iter(state["state"]["opt_state"]["mu"].values()))
    assert mu.dtype == torch.bfloat16


def test_resume_matches_uninterrupted(workdir):
    from ddpo_torch.pipelines import policy_gradient

    logdir = workdir.joinpath(*LOGDIR)
    rewards_full = policy_gradient.main(COMMON + ["--num_train_epochs", "3"])
    infos_full = _train_infos(logdir)
    curve_full = json.loads((logdir / "reward_curve.json").read_text())

    shutil.rmtree(workdir / "logs")
    shutil.rmtree(workdir / "bucket")
    rewards_a = policy_gradient.main(COMMON + ["--num_train_epochs", "2"])
    np.testing.assert_allclose(rewards_a, rewards_full[:2], rtol=1e-6)
    rewards_b = policy_gradient.main(COMMON + ["--num_train_epochs", "3", "--resume", "True"])
    np.testing.assert_allclose(rewards_b, rewards_full, rtol=1e-6)

    infos_resumed = _train_infos(logdir)
    assert set(infos_resumed) == set(infos_full) == {"0_0_0.npy", "0_1_0.npy", "0_2_0.npy"}
    for name, info in infos_full.items():
        np.testing.assert_allclose(infos_resumed[name]["loss"], info["loss"], rtol=1e-5,
                                   err_msg=f"train losses diverge after resume: {name}")
    curve = json.loads((logdir / "reward_curve.json").read_text())
    np.testing.assert_allclose(curve["mean"], curve_full["mean"], rtol=1e-6)


def test_sigterm_checkpoints_and_exits(workdir, monkeypatch):
    """The signal is raised from inside epoch 1's prompt generation; the
    pipeline finishes the epoch, checkpoints it and returns."""
    from ddpo_torch import training
    from ddpo_torch.pipelines import policy_gradient

    real_make_prompts = training.make_prompts
    calls = {"n": 0}

    def sigterm_on_second_call(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the first sample batch of epoch 1
            os.kill(os.getpid(), signal.SIGTERM)
        return real_make_prompts(*a, **kw)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(training, "make_prompts", sigterm_on_second_call)
    rewards = policy_gradient.main(COMMON + ["--num_train_epochs", "3"])
    monkeypatch.setattr(training, "make_prompts", real_make_prompts)
    assert len(rewards) == 2
    assert (workdir.joinpath(*CKPT_ROOT, "checkpoints", "1", "state.pt")).exists()
    assert signal.getsignal(signal.SIGTERM) == before

    rewards_resumed = policy_gradient.main(COMMON + ["--num_train_epochs", "3", "--resume", "True"])
    assert len(rewards_resumed) == 3 and rewards_resumed[:2] == rewards


def test_unported_options_raise(workdir, monkeypatch):
    """Every option of JAX's driver runs but generate under more than one
    process. JAX's three tp refusals hold, with
    its messages: tp with sp, LoRA with tp, --grad_reduce_dtype with tp (or
    sp). One process cannot hold a mesh of two (JAX's mesh ValueError), and
    --resident_inner_loop runs."""
    from ddpo_torch.pipelines import generate, policy_gradient

    one = COMMON + ["--num_train_epochs", "1"]
    for flags, message in (
        (["--mesh_tp", "2", "--mesh_sp", "2"], "mesh_sp and mesh_tp cannot be combined"),
        (["--mesh_tp", "2", "--lora_rank", "2"], "lora_rank requires tp=1"),
        (["--mesh_tp", "2", "--grad_reduce_dtype", "bfloat16"], "supports pure-dp meshes"),
        (["--mesh_sp", "2", "--grad_reduce_dtype", "bfloat16"], "supports pure-dp meshes"),
    ):
        with pytest.raises(AssertionError, match=message):
            policy_gradient.main(one + flags)
    for flags, shape in ((["--mesh_sp", "2"], "0x2x1"), (["--mesh_tp", "2"], "0x1x2")):
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 devices"):
            policy_gradient.main(one + flags)
    rewards = policy_gradient.main(one + ["--resident_inner_loop", "True"])
    assert len(rewards) == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE > 1"):
        generate.main(["--dataset", "debug-animals", "--device", "cpu"])


def test_checkpoints_background_write_prune_and_error(tmp_path):
    """One background write at a time; restore sees only complete steps;
    prune keeps the newest; a failed background write raises at the next
    wait instead of passing for saved."""
    from ddpo_torch.utils import checkpoints

    root = str(tmp_path / "run")
    for step in range(3):
        checkpoints.save_train_state(root, step, {"w": torch.full((3,), float(step))},
                                     host_state={"step": step}, block=False)
    checkpoints.wait_for_pending_saves()
    assert checkpoints.latest_checkpoint_step(root) == 2
    assert checkpoints.last_save["step"] == 2 and checkpoints.last_save["bytes"] > 0
    os.makedirs(os.path.join(root, "checkpoints", "3"))  # an unfinished write
    restored, step = checkpoints.restore_train_state(root)
    assert step == 2 and restored["w"].tolist() == [2.0] * 3 and restored["host"] == {"step": 2}
    assert checkpoints.prune_checkpoints(root, 2) == 2
    assert sorted(os.listdir(os.path.join(root, "checkpoints"))) == ["2", "2_host.pkl", "3"]

    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    checkpoints.save_train_state(str(blocker), 0, {"w": torch.zeros(1)}, block=False)
    with pytest.raises(RuntimeError, match="step 0 failed"):
        checkpoints.wait_for_pending_saves()
    checkpoints.wait_for_pending_saves()  # the error is reported once


def test_drivers_raise_without_a_card_unless_device_cpu(workdir):
    """Both drivers, load_stable_diffusion and build_models default to the
    card and raise at once without one; --device cpu runs them (above)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from ddpo_torch.pipelines import generate, policy_gradient
    from ddpo_torch.utils.serialization import build_models, load_stable_diffusion

    for main in (generate.main, policy_gradient.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--dataset", "debug-animals"])
    for build in (lambda: load_stable_diffusion(model_preset="tiny"),
                  lambda: build_models("tiny")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert not (workdir / "logs").exists()  # nothing ran before the check
