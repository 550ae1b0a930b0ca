"""The port's gs:// savepaths, on the DDPO_TPU_FAKE_GCS stand-in (a local
directory that gs:// paths map onto; nothing here has network).

  - the DDPO driver's artifacts land in the bucket, as JAX's
    tests/test_resume_and_sync.py::test_remote_savepath_artifacts_land_in_bucket
    holds for ddpo_tpu;
  - ``--resume`` from a fresh working directory fetches the checkpoints
    from the bucket and continues like an uninterrupted run (rewards rtol
    1e-6, train losses rtol 1e-5);
  - ``save_unet("gs://...")`` writes the bucket (and a local copy under
    logs/<bucket path>), not a local ./gs:/... tree;
  - the RWR chain on the bucket: sample, save_sizes and a finetune whose
    unet_1.pkl export lands in the bucket, then ``sample --iteration 1
    --loadpath gs://...`` reads that export back, bit for bit.
"""

import importlib
import os
import pickle

import numpy as np
import pytest
import torch

COMMON = [
    "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
    "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
    "--save_freq", "1", "--per_prompt_stats_bufsize", "8", "--per_prompt_stats_min_count", "2",
]
REMOTE = ["--logbase", "gs://testbucket/logs"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bucket(tmp_path, monkeypatch):
    """A working directory and the stand-in bucket's root."""
    work, fake = tmp_path / "work", tmp_path / "fake_gcs"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    monkeypatch.setenv("DDPO_TPU_FAKE_GCS", str(fake))
    import ddpo_torch.config.base as base
    import ddpo_torch.config.user as user

    importlib.reload(user)
    importlib.reload(base)
    yield fake
    monkeypatch.undo()
    importlib.reload(user)
    importlib.reload(base)


def _losses(logdir):
    return {f.name: np.load(f, allow_pickle=True).item()["loss"]
            for f in sorted((logdir / "train_info").iterdir())}


def test_remote_savepath_artifacts_land_in_bucket(bucket, tmp_path):
    from ddpo_torch.pipelines import policy_gradient

    policy_gradient.main(COMMON + ["--num_train_epochs", "1"] + REMOTE)
    remote = bucket / "testbucket" / "logs" / "models" / "pg"
    assert (remote / "reward_curve.json").exists()
    assert (remote / "log_0.png").exists()
    assert any((remote / "rewards").iterdir())
    assert any((remote / "samples").iterdir())
    assert (remote / "checkpoints" / "0" / "state.pt").exists()
    with open(remote / "checkpoints" / "0_host.pkl", "rb") as f:
        host = pickle.load(f)
    assert "per_prompt_stats" in host and "sample_generator" in host
    assert not (tmp_path / "work" / "gs:").exists()


def test_resume_from_a_fresh_host_fetches_from_the_bucket(bucket, tmp_path, monkeypatch):
    from ddpo_torch.pipelines import policy_gradient

    full = policy_gradient.main(COMMON + ["--num_train_epochs", "2"])
    full_losses = _losses(tmp_path / "work" / "logs" / "bucket" / "logs" / "debug-animals"
                          / "models" / "pg")
    first = tmp_path / "first"
    first.mkdir()
    monkeypatch.chdir(first)
    policy_gradient.main(COMMON + ["--num_train_epochs", "1"] + REMOTE)

    fresh = tmp_path / "fresh"
    fresh.mkdir()
    monkeypatch.chdir(fresh)
    resumed = policy_gradient.main(COMMON + ["--num_train_epochs", "2", "--resume", "True"]
                                   + REMOTE)
    local = fresh / "logs" / "testbucket" / "logs" / "models" / "pg"
    assert (local / "checkpoints" / "0" / "state.pt").exists()  # fetched
    assert (bucket / "testbucket" / "logs" / "models" / "pg" / "checkpoints" / "1"
            / "state.pt").exists()  # and the new epoch synced back
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, full, rtol=1e-6)
    losses = _losses(local)
    assert set(losses) == {"0_1_0.npy"}  # the fresh host trained epoch 1 only
    np.testing.assert_allclose(losses["0_1_0.npy"], full_losses["0_1_0.npy"], rtol=1e-5)


def test_save_unet_to_gs_lands_in_the_bucket(bucket, tmp_path):
    from ddpo_torch.utils.checkpoints import load_unet_pickle, save_unet
    from ddpo_torch.utils.serialization import build_models

    _, _, unet = build_models("tiny", "cpu")
    torch.nn.init.normal_(unet.conv_in.weight, generator=torch.Generator().manual_seed(0))
    path = save_unet("gs://testbucket/models/1", unet, epoch=3)
    remote = bucket / "testbucket" / "models" / "1" / "unet_3.pkl"
    assert remote.exists()
    assert not (tmp_path / "work" / "gs:").exists()
    assert os.path.abspath(path) == str(tmp_path / "work" / "logs" / "testbucket" / "models"
                                        / "1" / "unet_3.pkl")
    tree = load_unet_pickle("gs://testbucket/models/1")  # the newest, read through fs
    assert np.array_equal(tree["conv_in"]["kernel"],
                          unet.conv_in.weight.detach().permute(2, 3, 1, 0).numpy())


def test_rwr_chain_on_the_bucket(bucket):
    from ddpo_torch.models.convert import flax_tree_to_state_dict
    from ddpo_torch.pipelines import finetune, sample, save_sizes
    from ddpo_torch.utils.checkpoints import load_unet_pickle

    rwr = ["--dataset", "debug-animals", "--device", "cpu", "--resolution", "32"] + REMOTE
    n = sample.main(rwr + ["--n_inference_steps", "2", "--max_samples", "2",
                           "--n_samples_per_device", "1", "--local_size", "2"])
    assert n >= 2
    save_sizes.main(["--dataset", "debug-animals"] + REMOTE)
    ft = finetune.main(rwr + ["--num_train_epochs", "1", "--train_batch_size", "1",
                              "--save_freq", "1"])
    remote_models = "gs://testbucket/logs/models/1"
    assert (bucket / "testbucket" / "logs" / "models" / "1" / "unet_1.pkl").exists()

    args = sample.Parser().parse_args("sample", rwr + [
        "--iteration", "1", "--loadpath", remote_models, "--n_samples_per_device", "1",
        "--n_inference_steps", "2"])
    c = sample.build_collector(args)
    export = flax_tree_to_state_dict(load_unet_pickle(remote_models))
    trained = ft.models.unet.state_dict()
    for key, value in c.models.unet.state_dict().items():
        assert torch.equal(value.float(), export[key].float()), key
        assert torch.equal(export[key].float(), trained[key].float()), key
