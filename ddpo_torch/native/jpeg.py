"""ctypes binding for the native JPEG compressibility scorer.

Port of ddpo_tpu/native/jpeg.py without its PIL fallback: ``jpeg_sizes``
encodes with libjpeg through the C++ library or raises. Another encoder
would give another reward without saying so.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Optional

import numpy as np

_lib = None
_lock = threading.Lock()
# seconds the first use took to find (or build) and load the library
load_seconds: Optional[float] = None


def load(path: str):
    """ctypes handle of a built JPEG library, with ``jpeg_sizes`` bound."""
    lib = ctypes.CDLL(path)
    lib.jpeg_sizes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.jpeg_sizes.restype = ctypes.c_int
    return lib


def _get_lib():
    """Build (at first use) and load the library; raises if it cannot."""
    global _lib, load_seconds
    with _lock:
        if _lib is None:
            from ddpo_torch.native.build import build

            start = time.perf_counter()
            _lib = load(build())
            load_seconds = time.perf_counter() - start
    return _lib


def _to_uint8_batch(images: np.ndarray) -> np.ndarray:
    images = np.asarray(images)
    if images.dtype != np.uint8:
        if np.abs(images).max() > 1.0 + 1e-5:
            raise ValueError("float images must lie in [0, 1]")
        images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    return np.ascontiguousarray(images)


def jpeg_sizes(images: np.ndarray, quality: int = 95,
               n_threads: Optional[int] = None) -> np.ndarray:
    """(N, H, W, 3) images -> encoded JPEG sizes in bytes (libjpeg)."""
    return encoded_sizes(_get_lib(), images, quality, n_threads)


def encoded_sizes(lib, images: np.ndarray, quality: int = 95,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """``jpeg_sizes`` through the library handle ``lib`` (from ``load``)."""
    images = _to_uint8_batch(images)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (N, H, W, 3), got {images.shape}")
    n, h, w, _ = images.shape
    out = np.zeros(n, dtype=np.int64)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.jpeg_sizes(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, quality, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"jpeg_sizes failed with code {rc}")
    return out
