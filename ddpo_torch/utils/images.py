"""Image saving helpers and the RWR dataset's storage codecs.

PNG files are written with the standard library alone (zlib + struct), so
the serving path needs neither PIL nor matplotlib. ``save_images`` tiles a
batch into one grid image instead of drawing a matplotlib figure.

The codecs are ddpo_tpu/utils/images.py's: ``encode_jpeg``/``decode_jpeg``
(PIL, quality 95) for the images, ``encode_generic``/``decode_generic`` for
everything else. The JAX package pickles with dill; the port with the
standard ``pickle``, whose streams dill reads, and it reads dill's streams of
plain data (lists of prompts) and of module-level functions. The HDF5 files
(data/hdf5.py) keep their codec tables pickled in their attrs: a table
another package wrote names that package's codec functions, which
``decode_generic`` maps onto the port's own by name, so a file written by
either package is read by the other without importing it.
"""

from __future__ import annotations

import io
import math
import os
import pickle
import struct
import zlib

import numpy as np

from ddpo_torch.utils import filesystem as fs


def _to_uint8(x: np.ndarray) -> np.ndarray:
    if issubclass(x.dtype.type, np.floating):
        assert np.abs(x).max() <= 1.0 + 1e-5, "float images must be in [0, 1]"
        x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return x


def encode_png(x) -> bytes:
    """HWC (or HW) image, uint8 or [0, 1] float -> PNG file bytes."""
    img = _to_uint8(np.asarray(x))
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    # filter type 0 (None) at the start of every row
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    )
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def save_image(savepath: str, x) -> None:
    data = encode_png(x)
    if fs.is_remote(savepath):
        with fs.open(savepath, mode="wb") as f:
            f.write(data)
        return
    fs.mkdir(savepath, fname=True)
    with open(savepath, "wb") as f:
        f.write(data)


def save_images(images, *savepath, nrow: int = 8) -> None:
    """Tile a batch of HWC images into one grid PNG (nrow images per row)."""
    images = [_to_uint8(np.asarray(img)) for img in images]
    n = len(images)
    nrow = min(nrow, n)
    ncol = int(math.ceil(n / nrow))
    h, w, c = images[0].shape
    grid = np.zeros((ncol * h, nrow * w, c), np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    save_image(os.path.join(*savepath), grid)


def encode_jpeg(x: np.ndarray, quality: int = 95) -> np.ndarray:
    """HWC image (uint8 or [0, 1] float) -> JPEG bytes as a uint8 array."""
    from PIL import Image

    buffer = io.BytesIO()
    Image.fromarray(_to_uint8(np.asarray(x))).save(buffer, "JPEG", quality=quality)
    return np.frombuffer(buffer.getvalue(), dtype=np.uint8)


def decode_jpeg(jpeg: np.ndarray) -> np.ndarray:
    """JPEG bytes -> HWC float64 image in [0, 1]."""
    from PIL import Image

    return np.array(Image.open(io.BytesIO(bytes(jpeg)))) / 255.0


def encode_generic(x) -> np.ndarray:
    return np.frombuffer(pickle.dumps(x), dtype=np.uint8)


# modules whose codec functions a stored codec table may name
_CODEC_MODULES = ("ddpo_tpu.utils.images", "ddpo_tpu.data.hdf5", "ddpo_torch.utils.images")


class _CodecUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _CODEC_MODULES and name in _CODECS:
            return _CODECS[name]
        return super().find_class(module, name)


def decode_generic(x):
    return _CodecUnpickler(io.BytesIO(bytes(x))).load()


_CODECS = {fn.__name__: fn for fn in (encode_jpeg, decode_jpeg, encode_generic, decode_generic)}
