"""The harness's CPU tests: the checkout's root on the path, and the tiny
cell (the port's tiny preset at 64 px, fp32) that they run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_cell(lora: bool = False) -> dict:
    from h100_bench import run

    model = run.load_json(os.path.join(HERE, "tiny.json"))
    if lora:
        model.update(lora_rank=8, learning_rate=1e-3)
    return {"name": "tiny", "chips": 1, "model": model,
            "traffic": run.load_json(os.path.join(HERE, "tiny_traffic.json")),
            "limits": run.load_cell("ddpo.sd14.b8")["limits"],
            "end_to_end": [{"name": "ddpo_epoch_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": []}


@pytest.fixture
def cell():
    return tiny_cell()
