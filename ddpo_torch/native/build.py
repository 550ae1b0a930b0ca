"""Build the native JPEG-reward shared library (g++ + libjpeg).

Port of ddpo_tpu/native/build.py. The library is compiled at first use into
``build/native/`` beside the package (git-ignored), never into the package
directory. No pybind11: a plain C ABI consumed through ctypes.

The compile always takes libjpeg's headers from ``include/`` beside this
file (libjpeg-turbo 2.1.5, ABI 62; see its README), so a machine with a
libjpeg library but no development headers builds too. The link tries, in
order: the system's ``-ljpeg``; then an ABI-62 libjpeg by path,
``libjpeg.so.62*`` in the linker's directories and then ``libjpeg-*.so.62*``
in the ``*.libs`` directories of site-packages (the private copy a Pillow
wheel carries), linked with an rpath to its directory. The file name of the
built library carries a hash of the source, the headers, the flags and the
libjpeg chosen, so an edited source is rebuilt. ``linked`` records the
libjpeg of the library last built or loaded. If nothing links, ``build``
raises with every command's output: there is no other encoder.
"""

from __future__ import annotations

import glob
import hashlib
import os
import site
import subprocess
from typing import List, Optional, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "jpeg_reward.cc")
INCLUDE = os.path.join(_DIR, "include")
HEADERS = ("jpeglib.h", "jmorecfg.h", "jconfig.h")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SYSTEM = "-ljpeg"
LINKER_DIRS = ("/usr/lib*", "/lib*", "/usr/local/lib*")

# the libjpeg the JPEG library last built or loaded links: SYSTEM or a path
linked: Optional[str] = None


def _unique(paths: List[str]) -> List[str]:
    seen, out = set(), []
    for path in paths:
        real = os.path.realpath(path)
        if real not in seen:
            seen.add(real)
            out.append(path)
    return out


def linker_dir_libraries() -> List[str]:
    """``libjpeg.so.62*`` in the linker's directories and their multiarch
    subdirectories, one path per file."""
    found = []
    for pattern in LINKER_DIRS:
        for d in sorted(glob.glob(pattern)):
            found += sorted(glob.glob(os.path.join(d, "libjpeg.so.62*")))
            found += sorted(glob.glob(os.path.join(d, "*", "libjpeg.so.62*")))
    return _unique(found)


def site_packages_libraries() -> List[str]:
    """``libjpeg-*.so.62*`` in the ``*.libs`` directories of site-packages."""
    dirs = site.getsitepackages() + [site.getusersitepackages()]
    found = []
    for d in dirs:
        found += sorted(glob.glob(os.path.join(d, "*.libs", "libjpeg-*.so.62*")))
    return _unique(found)


def choices() -> List[str]:
    """What the link tries, in order: SYSTEM, then ABI-62 libraries by path."""
    return [SYSTEM, *linker_dir_libraries(), *site_packages_libraries()]


def link_args(libjpeg: str) -> List[str]:
    if libjpeg == SYSTEM:
        return [SYSTEM]
    return [libjpeg, f"-Wl,-rpath,{os.path.dirname(os.path.abspath(libjpeg))}"]


def compile_library(out: str, libjpeg: str) -> Tuple[bool, str]:
    """g++ the source into ``out`` against ``libjpeg`` (SYSTEM or a path);
    (whether it built, the command and its output)."""
    cmd = ["g++", *FLAGS, "-I", INCLUDE, SRC, "-o", out, *link_args(libjpeg), "-pthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode == 0, " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def library_path(libjpeg: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS + (libjpeg,)).encode())
    for path in (SRC, *(os.path.join(INCLUDE, h) for h in HEADERS)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libjpeg_reward_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile (if not built yet) and return the shared-library path."""
    global linked
    options = choices()
    for libjpeg in options:  # a library built earlier is loaded as it is
        if os.path.exists(library_path(libjpeg)):
            linked = libjpeg
            return library_path(libjpeg)
    os.makedirs(BUILD_DIR, exist_ok=True)
    outputs = []
    for libjpeg in options:
        lib = library_path(libjpeg)
        tmp = f"{lib}.tmp{os.getpid()}"
        ok, output = compile_library(tmp, libjpeg)
        outputs.append(output)
        if ok:
            os.replace(tmp, lib)
            linked = libjpeg
            return lib
    raise RuntimeError(
        "building the native JPEG library failed: no libjpeg links (tried -ljpeg, "
        "libjpeg.so.62* in the linker's directories and libjpeg-*.so.62* in "
        "site-packages' *.libs):\n" + "\n".join(outputs)
    )
