"""Import hygiene: the port imports neither jax nor ddpo_tpu nor h5py (the
RWR storage imports it at first use), nor the packages its checkpoint
readers, LLaVA clients and BLIP-2 do without (msgpack, safetensors,
requests, transformers, tokenizers, huggingface_hub), and builds nothing at
import time.

Runs in a fresh interpreter, since this test process imports both.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
import ddpo_torch
import ddpo_torch.pipelines.generate
import ddpo_torch.pipelines.policy_gradient
for info in pkgutil.walk_packages(ddpo_torch.__path__, "ddpo_torch."):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ddpo_tpu", "h5py",
                                    "msgpack", "safetensors", "requests", "transformers",
                                    "tokenizers", "huggingface_hub"))
print("LEAKED", bad)
# importing builds nothing: the kernels are built at first use on a CUDA tensor
# nor the JPEG reward's library: it is built at the reward's first call
import ddpo_torch.native.jpeg as jpeg
print("LIBRARY", ddpo_torch.ops._build._library, jpeg._lib)
sys.exit(1 if bad or ddpo_torch.ops._build._library is not None or jpeg._lib is not None else 0)
"""


def test_port_imports_neither_jax_nor_ddpo_tpu_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr



def test_chip_smoke_imports_none_of_them():
    """chip_smoke.py runs on the card's machine beside the port: no import
    of jax, ddpo_tpu or the Hub packages anywhere in it."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "ddpo_tpu", "transformers", "tokenizers",
                        "huggingface_hub"}, sorted(names)
    assert "ddpo_torch" in names
