"""The JPEG compressibility reward's sizes, encoded by Pillow.

Each image (N, H, W, 3) in [0, 1] becomes uint8 by truncation of x * 255,
as the reward does, and is encoded at quality 95 with Pillow's defaults
(libjpeg's: 4:2:0 chroma subsampling, the standard Huffman tables, the
integer DCT), which are the settings ``jpeg_set_defaults`` and
``jpeg_set_quality(95)`` give the program's own libjpeg encoder.
"""

from __future__ import annotations

import io

import numpy as np


def sizes(images: np.ndarray, quality: int = 95) -> np.ndarray:
    from PIL import Image

    pixels = (np.clip(np.asarray(images, dtype=np.float32), 0, 1) * 255).astype(np.uint8)
    out = np.zeros(len(pixels), dtype=np.int64)
    for i, image in enumerate(pixels):
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="JPEG", quality=quality)
        out[i] = buf.tell()
    return out
