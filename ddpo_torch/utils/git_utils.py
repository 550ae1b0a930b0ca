"""Experiment provenance: git revision + uncommitted-diff snapshot.

Reference: ddpo/utils/git_utils.py:8-35.
"""

from __future__ import annotations

import subprocess


def _git(*args: str) -> str:
    return subprocess.run(
        ["git", *args], capture_output=True, text=True, check=True
    ).stdout.strip()


def get_git_rev() -> str:
    try:
        rev = _git("rev-parse", "--short", "HEAD")
        branch = _git("rev-parse", "--abbrev-ref", "HEAD")
        return f"{rev} ({branch})"
    except Exception:
        return "unknown"


def save_git_diff(savepath: str) -> None:
    try:
        diff = _git("diff")
        with open(savepath, "w") as f:
            f.write(diff)
    except Exception:
        pass
