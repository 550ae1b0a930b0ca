"""Builds the CUDA kernels in ddpo_torch/csrc and binds them with ctypes.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for sm_90a, all
started together, and the objects link into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The library is built at first use on a CUDA tensor, under
``build/kernels/`` beside the package, and its file name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import time.

A failed build or load raises: there is no fallback to the plain versions.
Each kernel wrapper counts its launches in ``launches``, a plain integer per
kernel, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

# launches per kernel wrapper since the last reset
launches: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "gn_stats": 0,
}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(launches)


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: str, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an existing build was loaded
        self.log = log  # nvcc/ptxas output: registers, shared memory, spills
        lib = ctypes.CDLL(path)
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ddpo_flash_fwd.argtypes = (
            [p, p, p, p, p, i32, i32, i32, i32, i32, i32]
            + [i64] * 9
            + [ctypes.c_float, p]
        )
        lib.ddpo_flash_fwd.restype = i32
        # q, k, v, dout, lse, delta, outputs, dtype, B, H, Sq, Sk, D, strides, scale, stream
        lib.ddpo_flash_bwd_dq.argtypes = [p] * 7 + [i32] * 6 + [p, ctypes.c_float, p]
        lib.ddpo_flash_bwd_dq.restype = i32
        lib.ddpo_flash_bwd_dkv.argtypes = [p] * 8 + [i32] * 6 + [p, ctypes.c_float, p]
        lib.ddpo_flash_bwd_dkv.restype = i32
        lib.ddpo_gn_stats.argtypes = [p, p, p, p, i32, i64, i64, i32, p]
        lib.ddpo_gn_stats.restype = i32
        lib.ddpo_gn_stats_chunk.argtypes = []
        lib.ddpo_gn_stats_chunk.restype = i32
        lib.ddpo_error_string.argtypes = [i32]
        lib.ddpo_error_string.restype = ctypes.c_char_p
        self.lib = lib
        self.gn_chunk = int(lib.ddpo_gn_stats_chunk())

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.ddpo_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        path = os.path.join(BUILD_DIR, f"libddpo_kernels_{source_hash()}.so")
        log_path = path + ".log"
        build_seconds = 0.0
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            nvcc = _find_nvcc()
            cu_files = [s for s in _sources() if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu_files]
            start = time.perf_counter()
            # each compiler writes to a file: a full pipe would stall it
            logs = [open(f"{obj}.log", "w+") for obj in objs]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                 stdout=log, stderr=subprocess.STDOUT, text=True)
                for src, obj, log in zip(cu_files, objs, logs)
            ]
            for proc in procs:
                proc.wait()
            output = ""
            for log in logs:
                log.seek(0)
                output += log.read()
                log.close()
                os.remove(log.name)
            failed = [src for src, proc in zip(cu_files, procs) if proc.returncode != 0]
            if not failed:
                link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                output += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = ["the link"]
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            build_seconds = time.perf_counter() - start
            if failed:
                raise RuntimeError(
                    f"nvcc failed building the ddpo_torch kernels ({', '.join(failed)}):\n"
                    + output
                )
            with open(log_path, "w") as f:
                f.write(output)
            os.replace(tmp, path)
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        _library = KernelLibrary(path, build_seconds, log)
        return _library


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(str(dtype))
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
    return code
