"""The port's JPEG reward builds with its vendored libjpeg headers against
either libjpeg its build finds, and both give ddpo_tpu's sizes.

``jpeg_reward.cc`` is compiled twice into a temporary directory, with
``ddpo_torch/native/include``: once against the system's ``-ljpeg`` and once
by path against the first ABI-62 libjpeg that ``build.py``'s search finds in
site-packages' ``*.libs`` directories (a wheel's private copy). Sizes at
quality 95 must be equal to each other and to ``ddpo_tpu``'s, exactly: the
reward is the encoded byte count.
"""

import os
import shutil

import numpy as np
import pytest

from ddpo_torch.native import build as native_build
from ddpo_torch.native import jpeg as native_jpeg
from ddpo_tpu.native.jpeg import jpeg_sizes as jax_jpeg_sizes


def _images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, size=(4, 512, 512, 3), dtype=np.uint8)
    ramp = np.linspace(0, 255, 512, dtype=np.float32)
    smooth = np.stack([np.broadcast_to(ramp[None, :], (512, 512)),
                       np.broadcast_to(ramp[:, None], (512, 512)),
                       np.full((512, 512), 128.0, np.float32)], axis=-1)
    smooth = np.repeat(smooth[None].astype(np.uint8), 3, axis=0)
    odd = rng.integers(0, 256, size=(2, 37, 53, 3), dtype=np.uint8)
    return {"random": noise, "smooth": smooth, "odd": odd}


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native JPEG library cannot be built")
    found = native_build.site_packages_libraries()
    assert found, "build.py's search found no ABI-62 libjpeg in site-packages"
    out = tmp_path_factory.mktemp("jpeg_build")
    libs = {}
    for name, libjpeg in (("system", native_build.SYSTEM), ("by path", found[0])):
        path = str(out / f"libjpeg_reward_{name.replace(' ', '_')}.so")
        ok, output = native_build.compile_library(path, libjpeg)
        assert ok, output
        libs[name] = native_jpeg.load(path)
    return libs, found[0]


@pytest.mark.parametrize("kind", ["random", "smooth", "odd"])
def test_jpeg_sizes_equal_across_libjpegs_and_jax(libraries, kind):
    libs, path = libraries
    images = _images()[kind]
    system = native_jpeg.encoded_sizes(libs["system"], images, 95)
    by_path = native_jpeg.encoded_sizes(libs["by path"], images, 95)
    ref = jax_jpeg_sizes(images, quality=95)
    assert system.shape == (images.shape[0],) and (system > 0).all()
    np.testing.assert_array_equal(system, by_path, err_msg=os.path.basename(path))
    np.testing.assert_array_equal(system, ref)


def test_build_search_order_and_record():
    """-ljpeg first, then the linker's directories, then site-packages; the
    record names the libjpeg of the library built or loaded."""
    options = native_build.choices()
    assert options[0] == native_build.SYSTEM
    site = native_build.site_packages_libraries()
    assert options[len(options) - len(site):] == site
    assert all(".so.62" in os.path.basename(p) for p in options[1:])
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native JPEG library cannot be built")
    lib = native_build.build()
    assert os.path.exists(lib) and native_build.linked in options
    assert native_build.library_path(native_build.linked) == lib
