"""Readers and a writer for the two checkpoint file formats, with no package
beyond numpy and torch.

  - Flax's msgpack (``flax.serialization.msgpack_serialize``): a msgpack
    tree of maps whose leaves are ext type 1 (an ndarray: the msgpack triple
    (shape, dtype name, C-order bytes)) or ext type 3 (a numpy scalar, the
    same triple). Leaves above ``MAX_CHUNK_SIZE`` bytes are split into a
    map {"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": ...}} of flat pieces, as flax does. ``read_msgpack``
    reads the subset flax writes (maps, arrays, str/bin, int, float, nil,
    bool, ext 1 and 3 of float32, float16, bfloat16 or int64, chunked
    leaves); ``write_msgpack`` writes it, with
    map keys in sorted order as JAX's tree_map leaves them, so JAX's
    ``msgpack_restore`` reads the file.
  - safetensors: an 8-byte little-endian header length, a JSON header
    {name: {"dtype", "shape", "data_offsets"}} and the raw bytes.
    ``read_safetensors`` reads F32, F16, BF16 and I64 tensors.

numpy has no bfloat16: a "bfloat16" (msgpack) or "BF16" (safetensors)
leaf is read as its 16-bit pattern and viewed as ``torch.bfloat16``, and a
``torch.bfloat16`` leaf is written under the name "bfloat16".

Both readers map the file and hand back torch tensors that view it (a
leaf whose bytes are not aligned for its type is copied), so an SD-1.4
UNet's 3.44 GB reads without a second copy of the file in memory.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, BinaryIO, Dict, Mapping, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax/serialization.py: leaves above it are chunked

_CHUNKED = "__msgpack_chunked_array__"

# dtype names as each format writes them -> numpy type of the stored bytes
# (bfloat16's 16-bit patterns are viewed as torch.bfloat16)
_MSGPACK_DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": np.int16,
                   "int64": np.int64}
_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.int16, "I64": np.int64}

# msgpack type bytes of fixed-size scalars, and of sized objects (the
# length's format, the reader's method)
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: (">B", "_bin"), 0xC5: (">H", "_bin"), 0xC6: (">I", "_bin"),
          0xD9: (">B", "_str"), 0xDA: (">H", "_str"), 0xDB: (">I", "_str"),
          0xDC: (">H", "_array"), 0xDD: (">I", "_array"),
          0xDE: (">H", "_map"), 0xDF: (">I", "_map")}

Leaf = Union[np.ndarray, torch.Tensor]


def _mapped(path: str) -> mmap.mmap:
    """The whole file, mapped copy-on-write (writable views, no copy)."""
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def _tensor(buf, offset: int, np_dtype, shape, bf16: bool) -> torch.Tensor:
    """A tensor over ``buf[offset:]``; copied only where numpy finds the
    bytes unaligned for the type."""
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(buf, dtype=np_dtype, count=count, offset=offset)
    if not arr.flags.aligned:
        arr = arr.copy()
    t = torch.from_numpy(arr.reshape(tuple(shape)))
    return t.view(torch.bfloat16) if bf16 else t


# ---------------------------------- msgpack ---------------------------------- #


class _Reader:
    """A msgpack decoder over a buffer, by offset: nothing is sliced."""

    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def _take(self, fmt: str):
        value = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return value

    def _str(self, n: int) -> str:
        s = str(self.view[self.pos:self.pos + n], "utf-8")
        self.pos += n
        return s

    def _bin(self, n: int) -> memoryview:
        data = self.view[self.pos:self.pos + n]
        self.pos += n
        return data

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")
        if self.buf[self.pos] != 0x93:  # the triple: a fixarray of 3
            raise ValueError("malformed msgpack ndarray payload")
        self.pos += 1
        shape = self.read()
        dtype_name = self.read()
        if isinstance(dtype_name, memoryview):  # written as bin
            dtype_name = str(dtype_name, "utf-8")
        data = self.read()
        if self.pos != end or not isinstance(data, memoryview):
            raise ValueError("malformed msgpack ndarray payload")
        if dtype_name not in _MSGPACK_DTYPES:
            raise ValueError(f"msgpack ndarray of dtype {dtype_name!r} is not supported")
        np_dtype = _MSGPACK_DTYPES[dtype_name]
        if len(data) != int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize:
            raise ValueError(f"msgpack ndarray of shape {shape} holds {len(data)} bytes")
        return _tensor(data, 0, np_dtype, shape, dtype_name == "bfloat16")

    def read(self) -> Any:
        b = self.buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self._take(_SCALARS[b])
        if b in _SIZED:
            fmt, method = _SIZED[b]
            return getattr(self, method)(self._take(fmt))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._take(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8, 16, 32
            n = self._take({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._take(">b"), n)
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not supported")


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def read_msgpack(path: str) -> dict:
    """A flax msgpack file -> its tree, with torch tensors at the leaves
    (views of the mapped file; ext 3 scalars as 0-d tensors)."""
    reader = _Reader(_mapped(path))
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: {len(reader.buf) - reader.pos} bytes after the msgpack tree")
    return _unchunk(tree)


def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_sized(n: int, fix_base, fix_max: int, codes) -> bytes:
    """The header of a str, bin, array or map of length ``n``: its fix form
    where there is one, else the 8-, 16- or 32-bit length form."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw


def _leaf_bytes(x: Leaf):
    """(shape, dtype name, C-order bytes as a buffer) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().reshape(-1).view(np.uint8).data
        x = x.numpy()
    x = np.asarray(x, order="C")  # ascontiguousarray would make a 0-d leaf 1-d
    return x.shape, x.dtype.name, x.reshape(-1).view(np.uint8).data


def _write_leaf(f: BinaryIO, x: Leaf) -> None:
    shape, dtype_name, data = _leaf_bytes(x)
    nbytes = len(data)
    head = (b"\x93"  # the triple
            + _pack_sized(len(shape), 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_pack_uint(int(d)) for d in shape)
            + _pack_str(dtype_name)
            + _pack_sized(nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
    payload = len(head) + nbytes
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if payload in fixext:
        f.write(bytes([fixext[payload], 1]))
    else:
        f.write(_pack_sized(payload, None, 0, (0xC7, 0xC8, 0xC9)) + b"\x01")
    f.write(head)
    f.write(data)


def _chunked(x: Leaf) -> dict:
    """flax's chunked form of an oversized leaf (insertion order as flax's)."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = x.numel() if isinstance(x, torch.Tensor) else x.size
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(j): flat[i:i + step] for j, i in enumerate(range(0, size, step))},
    }


def _write_node(f: BinaryIO, node: Any, sort: bool) -> None:
    if isinstance(node, Mapping):
        f.write(_pack_sized(len(node), 0x80, 15, (None, 0xDE, 0xDF)))
        for key in (sorted(node) if sort else node):
            f.write(_pack_str(key))
            _write_node(f, node[key], sort)
    elif isinstance(node, bool):
        f.write(b"\xc3" if node else b"\xc2")
    elif isinstance(node, int):
        if node < 0:
            raise ValueError("negative ints are not part of a parameter tree")
        f.write(_pack_uint(node))
    elif isinstance(node, (np.ndarray, torch.Tensor)):
        nbytes = (node.numel() * node.element_size() if isinstance(node, torch.Tensor)
                  else node.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            _write_node(f, _chunked(node), sort=False)
        else:
            _write_leaf(f, node)
    else:
        raise TypeError(f"cannot write a {type(node).__name__} leaf")


def write_msgpack(path: str, tree: Mapping[str, Any]) -> int:
    """Write ``tree`` (nested str-keyed maps of numpy arrays or torch
    tensors) as flax's msgpack; the file's size in bytes."""
    with open(path, "wb") as f:
        _write_node(f, tree, sort=True)
        return f.tell()


# -------------------------------- safetensors -------------------------------- #


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: tensor} in the header's order (views of
    the mapped file)."""
    buf = _mapped(path)
    (n,) = struct.unpack_from("<Q", buf, 0)
    header = json.loads(str(memoryview(buf)[8:8 + n], "utf-8"))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        np_dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end - begin != int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize \
                or base + end > len(buf):
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} "
                             f"for shape {shape} {info['dtype']}")
        out[name] = _tensor(buf, base + begin, np_dtype, shape, info["dtype"] == "BF16")
    return out
