"""Build the native JPEG-reward shared library (g++ + libjpeg).

Port of ddpo_tpu/native/build.py. The library is compiled at first use into
``build/native/`` beside the package (git-ignored), never into the package
directory, and its file name carries a hash of the source, so an edited
source is rebuilt. No pybind11: a plain C ABI consumed through ctypes.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "jpeg_reward.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-pthread")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libjpeg_reward_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile (if not built yet) and return the shared-library path."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "building the native JPEG library failed (it needs g++ and libjpeg's "
            "headers and library):\n" + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
    os.replace(tmp, lib)
    return lib
