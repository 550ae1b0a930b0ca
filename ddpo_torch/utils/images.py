"""Image saving helpers and the RWR dataset's storage codecs.

PNG files are written with the standard library alone (zlib + struct), so
the serving path needs neither PIL nor matplotlib. ``save_images`` tiles a
batch into one grid image instead of drawing a matplotlib figure.
``plot_calibration`` draws the guidance-scale curve with matplotlib where it
imports, else with PIL.

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


def plot_calibration(savepath: str, y_dict: dict, ylabel=None, cache: str = "logs") -> str:
    """Reward against guidance scale, the calibration driver's curve (JAX's
    plot_calibration, reference :402-428), as a PNG at ``savepath``.

    Drawn with matplotlib on the Agg backend, as JAX draws it, where
    matplotlib imports; else the same curve (the grey face, white grid
    lines, the line in matplotlib's first colour, the axis labels) with
    PIL's ImageDraw. Returns which one drew it: "matplotlib" or "pil".
    """
    xs = sorted(y_dict.keys())
    ys = [y_dict[x] for x in xs]
    try:
        import matplotlib
    except ImportError:
        data, renderer = _plot_pil(xs, ys, ylabel), "pil"
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(xs, ys)
        ax = plt.gca()
        ax.grid(linestyle="-", linewidth="1", color="white")
        ax.set_facecolor([0.9, 0.9, 0.9])
        for spine in ax.spines.values():
            spine.set_visible(False)
        plt.ylabel(ylabel)
        plt.xlabel("guidance scale")
        buffer = io.BytesIO()
        plt.savefig(buffer, format="png")
        plt.close()
        data, renderer = buffer.getvalue(), "matplotlib"
    if fs.is_remote(savepath):
        localpath = os.path.join(cache, savepath.replace("gs://", ""))
        fs.mkdir(localpath, fname=True)
        with open(localpath, "wb") as f:
            f.write(data)
        with fs.open(savepath, mode="wb") as f:
            f.write(data)
    else:
        fs.mkdir(savepath, fname=True)
        with open(savepath, "wb") as f:
            f.write(data)
    return renderer


def _plot_pil(xs, ys, ylabel, size=(640, 480), margin=(80, 30, 30, 60)) -> bytes:
    """The calibration curve with PIL's ImageDraw: PNG bytes."""
    from PIL import Image, ImageDraw

    width, height = size
    left, top, right, bottom = margin
    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    x0, y0, x1, y1 = left, top, width - right, height - bottom
    draw.rectangle([x0, y0, x1, y1], fill=(230, 230, 230))
    xlo, xhi = min(xs), max(xs)
    ylo, yhi = min(ys), max(ys)
    xpad = (xhi - xlo) * 0.05 or 0.5
    ypad = (yhi - ylo) * 0.05 or 0.5

    def px(x, y):
        return (x0 + (x - xlo + xpad) / (xhi - xlo + 2 * xpad) * (x1 - x0),
                y1 - (y - ylo + ypad) / (yhi - ylo + 2 * ypad) * (y1 - y0))

    for i in range(5):
        gy = ylo - ypad + (yhi - ylo + 2 * ypad) * i / 4
        _, py = px(xlo, gy)
        draw.line([(x0, py), (x1, py)], fill="white", width=1)
        draw.text((4, py - 6), f"{gy:.3g}", fill="black")
    for x in xs:
        gx, _ = px(x, ylo)
        draw.line([(gx, y0), (gx, y1)], fill="white", width=1)
        draw.text((gx - 8, y1 + 6), f"{x:g}", fill="black")
    draw.line([px(x, y) for x, y in zip(xs, ys)], fill=(31, 119, 180), width=2)
    draw.text(((x0 + x1) // 2 - 40, height - 24), "guidance scale", fill="black")
    if ylabel:
        draw.text((4, 6), str(ylabel), fill="black")
    buffer = io.BytesIO()
    img.save(buffer, "PNG")
    return buffer.getvalue()


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
