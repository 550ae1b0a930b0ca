"""The port's guidance-scale calibration driver and plot_calibration, on the
CPU (debug-animals, the tiny preset, --device cpu).

What tests/test_pipelines_rwr.py::test_calibrate_then_auto_sample holds
for the JAX driver, and more: the sweep writes
calibration.json (mean, std, sem and n for each scale, and the best),
metadata.json and calibration.png, the best is the argmax of the means,
every scale starts from the same initial latents and per-step noise, and
``generate --guidance_scale auto`` reads the scale back.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import workdir  # noqa: F401

ARGV = ["--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--n_samples_per_device", "2", "--seed", "1"]


@pytest.fixture
def brightness_reward(monkeypatch):
    """The dataset's filter_field (arange, the image's index) replaced by
    the image's mean, which moves with the guidance scale."""
    from ddpo_torch import training

    def brightness_fn(**kwargs):
        def _fn(images, prompts, metadata):
            return np.asarray(images).mean(axis=(1, 2, 3)), {}
        return _fn

    monkeypatch.setitem(training.callback_fns, "arange", brightness_fn)


def test_calibrate_writes_curve_metadata_and_plot(workdir, brightness_reward, monkeypatch):  # noqa: F811
    from ddpo_torch.pipelines import calibrate

    first_latents = []  # each sampler call's first UNet input
    real = calibrate.sample_images

    def recording(unet, *args, **kwargs):
        inputs = []

        def spy(latents, t, context):
            inputs.append(latents.clone())
            return unet(latents, t, context)

        out = real(spy, *args, **kwargs)
        first_latents.append(inputs[0])
        return out

    monkeypatch.setattr(calibrate, "sample_images", recording)
    scales = [1.0, 4.0, 9.0]
    result = calibrate.main(ARGV + ["--guidance_scales", str(scales), "--n_eval_batches", "2"])

    savepath = workdir / "bucket" / "logs" / "debug-animals" / "models" / "0"
    with open(savepath / "calibration.json") as f:
        cal = json.load(f)
    with open(savepath / "metadata.json") as f:
        meta = json.load(f)
    assert (savepath / "calibration.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert result.renderer in ("matplotlib", "pil")
    means = {float(s): v["mean"] for s, v in cal["curve"].items()}
    assert set(means) == set(scales)
    assert all(v["n"] == 4 and v["std"] >= 0 and v["sem"] >= 0 for v in cal["curve"].values())
    assert cal["best"] == max(means, key=means.get) == result.best
    assert meta == {"guidance_scale": result.best, "filter_field": "arange"}
    assert len(set(means.values())) == len(scales)  # the reward moved with the scale

    # one UNet input per sampler call: each batch's scales start alike,
    # and the two batches start from different draws
    assert len(first_latents) == 2 * len(scales)
    for batch in (first_latents[:3], first_latents[3:]):
        assert all(torch.equal(x, batch[0]) for x in batch)
    assert not torch.equal(first_latents[0], first_latents[3])


def test_generate_auto_reads_the_calibrated_scale(workdir, brightness_reward, capsys):  # noqa: F811
    from ddpo_torch.pipelines import calibrate, generate

    result = calibrate.main(ARGV + ["--guidance_scales", "[2.0, 6.0]"])
    loadpath = str(workdir / "bucket" / "logs" / "debug-animals" / "models" / "0")
    capsys.readouterr()
    gen = generate.main(["--dataset", "debug-animals", "--device", "cpu", "--n_samples", "1",
                         "--n_inference_steps", "2", "--resolution", "32",
                         "--guidance_scale", "auto", "--loadpath", loadpath])
    assert f"calibrated guidance scale: {result.best:g}" in capsys.readouterr().out
    with open(os.path.join(gen.outdir, "prompts.json")) as f:
        assert json.load(f)["guidance_scale"] == result.best


@pytest.mark.parametrize("renderer", ["matplotlib", "pil"])
def test_plot_calibration_renderers(tmp_path, monkeypatch, renderer):
    """matplotlib where it imports (JAX's renderer), else PIL's ImageDraw."""
    import builtins

    from ddpo_torch.utils.images import plot_calibration

    if renderer == "pil":
        real_import = builtins.__import__

        def no_matplotlib(name, *args, **kwargs):
            if name.split(".")[0] == "matplotlib":
                raise ImportError("no matplotlib")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    else:
        pytest.importorskip("matplotlib")
    path = str(tmp_path / "sub" / "calibration.png")
    drew = plot_calibration(path, {1.0: 0.2, 3.0: 0.5, 8.0: 0.4}, ylabel="jpeg")
    assert drew == renderer
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
