"""Loading cells by name, the configurations against the port's SD-1.4
stack, the result line's format, the trace's reduction, and that nothing
the harness or the reference runs loads JAX."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from h100_bench import run, trace
from h100_bench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "h100_bench")
CELLS = ["ddpo.sd14.b8"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_by_name(name):
    cell = run.load_cell(name)
    assert cell["traffic"]["driver"] == "ddpo"
    assert os.path.exists(os.path.join(BENCH, "drivers", "ddpo.py"))
    assert {m["name"] for m in cell["end_to_end"]} == {"ddpo_epoch_s", "setup_s"}
    for m in cell["per_layer"] + cell["end_to_end"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    from h100_bench.checks import ddpo

    assert set(cell["limits"]) == set(ddpo.ORDER) - {"approx_kl", "clipfrac"}


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no.such.cell")


def test_benchmark_json_names_and_paths():
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert bench["paths"] == ["h100_bench"]
    assert [w["name"] for w in bench["workloads"]] == CELLS
    assert [c["name"] for c in bench["configs"]] == ["sd14"]
    for c in bench["configs"]:
        assert c["file"].startswith("h100_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert m["moves"] == "ddpo_epoch_s" and m["workloads"] == CELLS


@pytest.mark.parametrize("config", ["sd14", "sd14-lora8"])
def test_configs_are_the_ports_sd14(config):
    """The file's groups build the port's own SD-1.4 configs; the UNet has
    859,520,964 parameters and LoRA rank 8 1,594,368 trainables."""
    from ddpo_torch.models import CLIPTextConfig, UNet2DCondition, UNetConfig, VAEConfig
    from ddpo_torch.models.lora import target_paths
    from h100_bench.drivers.ddpo import port_configs

    model = run.load_json(os.path.join(BENCH, "configs", config + ".json"))
    text, vae, unet = port_configs(model)
    assert (text, vae, unet) == (CLIPTextConfig(), VAEConfig(), UNetConfig())
    with torch.device("meta"):
        params = dict(UNet2DCondition(unet).named_parameters())
    assert sum(p.numel() for p in params.values()) == 859_520_964
    paths = target_paths(params, tuple(model["lora_targets"]))
    trainables = sum(params[p + ".weight"].shape[0] + params[p + ".weight"].shape[1]
                     for p in paths) * 8
    assert trainables == 1_594_368
    assert model["train_timestep_ratio"] == 0.4
    assert (model["lora_rank"], model["learning_rate"]) == ((8, 1e-3) if "lora" in config
                                                            else (0, 1e-5))


def test_result_line_format():
    fake = types.SimpleNamespace(epochs=2, trace={"busy_s": 1.0, "window_s": 2.0,
                                                  "device_ops": [["a", 0.5]],
                                                  "idle_gaps": [["train", 0.25]]})
    checks = [("text", 0.001, 0.01), ("grad", 0.2, 0.1)]
    line = run.result_line(fake, {"ddpo_epoch_s": {"value": 20.5, "unit": "s"}}, checks, False,
                           {"platform": "gpu", "kind": "x", "count": 1,
                            "memory_peak_bytes": 5}, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["checks"]["grad"] == {"value": 0.2, "limit": 0.1}
    assert json.loads(json.dumps(line)) == line
    untraced = run.result_line(fake, {}, checks, True, {}, trace=False)
    assert list(untraced) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_trace_summary_labels_idle_gaps():
    families = trace.load_families()
    kernels = [("flash_fwd_wgmma_kernel", 0.0, 1.0), ("void tap_gemm_wgmma_kernel<1>", 2.0, 3.0),
               ("elementwise_kernel", 3.5, 4.0)]
    spans = {"sampler": [(10.0, 12.5)], "train": [(12.5, 15.0)]}
    s = trace.summarize(kernels, spans, host_origin=10.0, device_origin=0.0, window_s=5.0,
                        families=families)
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["by_family"]["attention"] == pytest.approx(1.0)
    assert s["by_family"]["tap-GEMM"] == pytest.approx(1.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["sampler"] == pytest.approx(1.0)
    assert gaps["train"] == pytest.approx(0.5 + 1.0)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax_and_read_no_old_bench():
    """No harness or reference file imports a forbidden package by its
    top-level name (ddpo_torch starts with ddpo_ and passes), the reference
    imports nothing of the program, and none names the root bench files."""
    for folder, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(folder, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(run.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "ddpo_torch" not in tops, path
            text = open(path).read()
            if "tests" not in folder:
                assert "BENCH_" not in text and "bench_baseline" not in text, path


def test_a_tiny_run_loads_no_jax():
    """A whole tiny run in a fresh process (set-up, window, check) leaves
    no module with a forbidden top-level name in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from h100_bench.tests.conftest import tiny_cell\n"
        "from h100_bench import run\n"
        "run.set_environment()\n"
        "r, metrics, checks, correct, info = run.measure(tiny_cell(), 11, 0.1, False, 'cpu')\n"
        "print(run.forbidden_modules(), correct)\n" % ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness, the
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
