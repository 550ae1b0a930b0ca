"""Prompt-file loaders.

Parses the structured VQA prompt format and plain prompt lists used by the
prompt functions (reference: ddpo/utils/serialization.py:483-518; assets are
the PROMPT:/SUB Q:/SUB A:/VERB Q:/... files under assets/).
"""

from __future__ import annotations

import functools
import os


def resolve_asset(path: str) -> str:
    """Resolve a path like 'assets/common_animals.txt' against the repo root."""
    if os.path.exists(path):
        return path
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    candidate = os.path.join(root, path)
    if os.path.exists(candidate):
        return candidate
    return path


@functools.cache
def load_lines(loadpath: str):
    """One prompt per line, unstructured."""
    with open(resolve_asset(loadpath)) as f:
        return [line.strip() for line in f.readlines()]


@functools.cache
def load_general_prompts(path: str):
    """Structured VQA prompts -> [{prompt, questions, answers}, ...]."""
    dataset = []
    with open(resolve_asset(path)) as f:
        while True:
            line = f.readline()
            if line == "":
                break
            if line == "\n":
                continue
            assert line.startswith("PROMPT: "), line
            entry = {
                "prompt": line[len("PROMPT: "):].strip(),
                "questions": [],
                "answers": [],
            }
            for key in ["SUB", "VERB", "OBJ"]:
                line = f.readline()
                assert line.startswith(f"{key} Q: "), line
                entry["questions"].append(line[len(f"{key} Q: "):].strip())
                line = f.readline()
                assert line.startswith(f"{key} A: "), line
                entry["answers"].append(line[len(f"{key} A: "):].strip())
            dataset.append(entry)
    return dataset


def load_vqa_data(path: str):
    """Columnar variant of the VQA prompt format (reference :439-480)."""
    entries = load_general_prompts(path)
    return {
        "prompts": [e["prompt"] for e in entries],
        "sub_qs": [e["questions"][0] for e in entries],
        "verb_qs": [e["questions"][1] for e in entries],
        "obj_qs": [e["questions"][2] for e in entries],
        "sub_ans": [e["answers"][0] for e in entries],
        "verb_ans": [e["answers"][1] for e in entries],
        "obj_ans": [e["answers"][2] for e in entries],
    }


def load_guidance_scale(loadpath: str) -> float:
    """Read guidance_scale from a run's metadata.json (reference :431-436)."""
    import os

    from ddpo_torch.utils import filesystem as fs

    metadata = fs.read_json(os.path.join(loadpath, "metadata.json"))
    return float(metadata["guidance_scale"])
