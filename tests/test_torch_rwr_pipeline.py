"""The port's RWR drivers end to end on the CPU (debug-animals, tiny preset).

What tests/test_pipelines_rwr.py::test_rwr_chain holds for the JAX drivers,
with --device cpu at 32 px and 2 sampling steps: sample -> save_sizes ->
finetune -> sample --iteration 1 on the export, with their metrics streams;
the rwr_loop driver for one iteration; a LoRA finetune whose merged export
ddpo_tpu's ``load_unet`` reads bit for bit; the serving extras (--scheduler
dpm++, --quant int8, both); and the drivers raise without a card unless
given --device cpu.
"""

import numpy as np
import pytest
import torch

from test_torch_pipeline import workdir  # noqa: F401

COMMON = ["--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
          "--resolution", "32"]
TRAIN = ["--dataset", "debug-animals", "--device", "cpu", "--resolution", "32",
         "--num_train_epochs", "1", "--train_batch_size", "1", "--save_freq", "1"]
BASE = ("bucket", "logs", "debug-animals")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(n=4, extra=()):
    from ddpo_torch.pipelines import sample

    return sample.main(COMMON + ["--max_samples", str(n), "--n_samples_per_device", "1",
                                 "--local_size", "4", *extra])


def test_rwr_chain(workdir):  # noqa: F811
    from ddpo_torch.pipelines import finetune, save_sizes
    from ddpo_torch.utils.metrics import read_metrics

    n = _sample()
    assert n >= 4
    manifest = save_sizes.main(["--dataset", "debug-animals"])
    assert sum(manifest.values()) == n

    ft = finetune.main(TRAIN)
    models_dir = workdir.joinpath(*BASE, "models", "1")
    assert (models_dir / "unet_1.pkl").exists() and ft.state.step == n

    # iteration 1 loads the finetuned unet and samples again
    n2 = _sample(1, ["--iteration", "1", "--max_steps", "1", "--savepath", "samples/1"])
    assert n2 >= 1

    base = workdir.joinpath(*BASE)
    sample_events = read_metrics(str(base / "samples" / "0"))
    assert sample_events and sample_events[0]["phase"] == "sample"
    assert sample_events[-1]["n_total"] == n
    assert all(e[k] > 0 for e in sample_events
               for k in ("sample_s", "decode_s", "reward_arange_s", "reward_vae_s", "write_s",
                         "images_per_sec"))
    events = read_metrics(str(models_dir))
    assert events and events[0]["phase"] == "finetune" and np.isfinite(events[0]["loss"])
    assert events[0]["global_step"] == n and events[0]["save_bytes"] > 0


def test_iteration_1_samples_from_the_export(workdir):  # noqa: F811
    """The finetuned UNet that sample --iteration 1 loads is the export."""
    from ddpo_torch.pipelines import finetune, sample
    from ddpo_torch.utils.checkpoints import load_unet_pickle
    from ddpo_torch.models.convert import flax_tree_to_state_dict

    _sample(2)
    ft = finetune.main(TRAIN + ["--max_train_steps", "2"])
    args = sample.Parser().parse_args("sample", COMMON + ["--iteration", "1",
                                                          "--n_samples_per_device", "1"])
    c = sample.build_collector(args)
    export = flax_tree_to_state_dict(load_unet_pickle(args.loadpath))
    trained = ft.models.unet.state_dict()
    for key, value in c.models.unet.state_dict().items():
        assert torch.equal(value, export[key]) and torch.equal(value, trained[key]), key
    batch, mask, rewards, seconds = sample.collect_batch(c)
    assert batch["vae"].shape == (1, 16, 16, 8) and mask.all()
    assert set(seconds) == {"sample_s", "decode_s", "reward_arange_s", "reward_vae_s"}


def test_rwr_loop_one_iteration(workdir):  # noqa: F811
    from ddpo_torch.pipelines import rwr_loop
    from ddpo_torch.utils import fs

    rwr_loop.main(["--dataset", "debug-animals", "--iterations", "1", "--eval_samples", "2",
                   "--device", "cpu"])
    base = workdir.joinpath(*BASE)
    for samples in ("0_reference", "0", "1_reference"):
        assert sum(fs.unpickle(str(base / "samples" / samples / "sizes.pkl")).values()) >= 2
    # one epoch at save_freq 100: the export is numbered (0 + 1) // 100 * 100,
    # as the JAX driver numbers it; the final sample loaded it as "latest"
    assert (base / "models" / "1" / "unet_0.pkl").exists()


def test_lora_finetune_export_is_read_by_jax(workdir):  # noqa: F811
    import jax
    import jax.numpy as jnp

    from ddpo_torch.models.convert import from_flax
    from ddpo_torch.models.lora import merge_lora
    from ddpo_torch.pipelines import finetune
    from ddpo_tpu.utils.serialization import load_unet as jax_load_unet

    _sample(2)
    ft = finetune.main(TRAIN + ["--lora_rank", "2"])
    assert all(k.endswith((".a", ".b")) for k in ft.state.params)
    models_dir = workdir.joinpath(*BASE, "models", "1")
    _, params = jax_load_unet(str(models_dir), epoch=1, model_preset="tiny", dtype=jnp.float32)
    loaded = from_flax({"unet": jax.tree_util.tree_map(np.asarray, params["unet"])})["unet"]
    with torch.no_grad():
        merged = merge_lora(ft.lora_base, ft.state.params)
    assert set(loaded) == set(ft.models.unet.state_dict())
    changed = 0
    for key, value in loaded.items():
        want = merged.get(key, ft.lora_base[key])
        assert torch.equal(value, want), key
        changed += not torch.equal(want, ft.lora_base[key])
    assert changed > 0  # the adapters trained


@pytest.mark.parametrize("flag,value", [("--scheduler", "dpm++"), ("--quant", "int8")])
def test_sample_options_not_ported_raise(workdir, flag, value):  # noqa: F811
    """The serving extras, once refused here, are ported: collection runs
    with the value (the ODE sampler, or the quantized UNet), and an unknown
    value of the flag raises."""
    from ddpo_torch.data.hdf5 import LocalReader

    n = _sample(1, [flag, value, "--max_steps", "1", "--savepath", "samples/x"])
    reader = LocalReader(str(workdir.joinpath(*BASE, "samples", "x")))
    assert n >= 1 and len(reader) == n
    assert np.isfinite(np.asarray(reader.get(slice(0, n), field="images"), np.float32)).all()
    with pytest.raises(ValueError, match="unknown"):
        _sample(1, [flag, value + "x"])


def test_sample_dpmpp_int8_collects(workdir):  # noqa: F811
    """--quant int8 with --scheduler dpm++ (the cheapest collection): the
    collector samples with the ODE solver on the quantized UNet."""
    from ddpo_torch.core.scheduler import DPMSolverPlusPlus
    from ddpo_torch.models.layers import Conv3x3
    from ddpo_torch.pipelines import sample
    from ddpo_torch.sampling import sample_images_ode

    args = sample.Parser().parse_args("sample", COMMON + [
        "--n_samples_per_device", "1", "--quant", "int8", "--scheduler", "dpm++",
        "--n_inference_steps", "3"])
    c = sample.build_collector(args, [])
    assert isinstance(c.scheduler, DPMSolverPlusPlus) and c.sample_fn is sample_images_ode
    assert c.scheduler.prediction_type == c.models.scheduler.prediction_type
    assert sum(m.quant for m in c.models.unet.modules() if isinstance(m, Conv3x3)) == 17
    batch, mask, rewards, seconds = sample.collect_batch(c)
    assert np.isfinite(batch["images"]).all() and batch["vae"].shape == (1, 16, 16, 8)


@pytest.mark.parametrize("driver", ["sample", "finetune"])
def test_drivers_raise_without_a_card(workdir, monkeypatch, driver):  # noqa: F811
    from ddpo_torch.pipelines import finetune, sample

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in (COMMON if driver == "sample" else TRAIN)]
    del argv[argv.index("--device"):argv.index("--device") + 2]
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        {"sample": sample, "finetune": finetune}[driver].main(argv)
