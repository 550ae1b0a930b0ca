"""Sharded HDF5 dataset storage with per-field codecs.

Port of ddpo_tpu/data/hdf5.py, with the same file layout, so each package
reads the other's files: one dataset per field (fixed-shape arrays, or
variable-length byte strings for encoded fields), created at the first row
and cut to the rows written at close; the codec tables pickled in the file
attrs ``encode_fns``/``decode_fns``; split files named
``{timestamp}-w{process}-{randstr}.hdf5``, uploaded to a bucket on rollover
when the savepath is remote; random-access readers driven by a
``sizes.pkl`` manifest mapping global indices to (file, local index).

The port runs one process (parallel/collectives.py: rank 0 of 1). h5py is imported
at first use, never with the module.
"""

from __future__ import annotations

import glob
import os
import random
import string
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np

from ddpo_torch.parallel.collectives import process_index, softmax_ref
from ddpo_torch.utils import filesystem as fs
from ddpo_torch.utils.images import (
    decode_generic,
    decode_jpeg,
    encode_generic,
    encode_jpeg,
)

__all__ = [
    "H5Writer", "H5Reader", "H5Modifier", "RemoteWriter", "RemoteReader",
    "SlowRemoteReader", "LocalReader", "make_weights", "write_images",
    "encode_jpeg", "decode_jpeg", "encode_generic", "decode_generic",
]


def _h5py():
    import h5py

    return h5py


def timestamp() -> str:
    return time.strftime("%y-%m-%d_%H:%M:%S")


def randstr(n: int = 10) -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def _slice2range(s: slice) -> np.ndarray:
    return np.arange(s.start or 0, s.stop, s.step or 1)


class H5Writer:
    """Schema-per-field HDF5 writer with optional per-field codecs."""

    def __init__(self, savepath: str):
        fs.mkdir(savepath, fname=True)
        self._make_file(savepath)

    def _make_file(self, savepath: str) -> None:
        self.savepath = savepath
        self._file = _h5py().File(savepath, "w")
        self._sizes: Dict[str, int] = {}
        self._max_sizes: Dict[str, int] = {}
        self._vlens: Dict[str, bool] = {}
        self._encode_fns: Dict[str, Optional[Callable]] = {}
        self._decode_fns: Dict[str, Optional[Callable]] = {}

    def configure(
        self,
        field: str,
        max_size: int,
        vlen: bool = False,
        encode_fn: Optional[Callable] = None,
        decode_fn: Optional[Callable] = None,
    ) -> None:
        self._sizes[field] = 0
        self._max_sizes[field] = int(max_size)
        self._vlens[field] = vlen or encode_fn is not None
        self._encode_fns[field] = encode_fn
        self._decode_fns[field] = decode_fn

    def configure_from_reader(self, reader, max_size: int) -> None:
        for field in reader.fields:
            self.configure(
                field,
                max_size,
                encode_fn=reader.encode_fns.get(field),
                decode_fn=reader.decode_fns.get(field),
            )

    def _create_dataset(self, field: str, x) -> None:
        h5py = _h5py()
        dtype = x.dtype if hasattr(x, "dtype") else type(x)
        max_size = self._max_sizes[field]
        if self._vlens[field] or not hasattr(x, "shape"):
            dtype = h5py.special_dtype(vlen=dtype)
            shape = (max_size,)
        else:
            shape = (max_size,) + x.shape
        self._file.create_dataset(field, shape, dtype=dtype, chunks=True)

    def add(self, field: str, x, skip_encoding: bool = False) -> None:
        encode_fn = self._encode_fns[field]
        if encode_fn is not None and not skip_encoding:
            x = encode_fn(x)
        if isinstance(x, str):
            x = x.encode()
        size = self._sizes[field]
        if size == 0:
            self._create_dataset(field, x)
        self._file[field][size] = x
        self._sizes[field] += 1

    def adds(self, field: str, xs, **kwargs) -> None:
        for x in xs:
            self.add(field, x, **kwargs)

    def add_batch(self, batch: Dict, mask=None, **kwargs) -> int:
        sizes = [len(val) for val in batch.values()]
        assert len(set(sizes)) == 1, f"unequal batch sizes: {sizes}"
        indices = range(sizes[0]) if mask is None else np.where(mask)[0]
        for i in indices:
            for key, val in batch.items():
                self.add(key, val[i], **kwargs)
        return len(indices)

    def close(self) -> None:
        for field, size in self._sizes.items():
            if field not in self._file:
                continue
            old_shape = self._file[field].shape
            self._file[field].resize((size,) + old_shape[1:])
        self._file.attrs.update(
            {
                "encode_fns": encode_generic(self._encode_fns),
                "decode_fns": encode_generic(self._decode_fns),
            }
        )
        self._file.close()


class H5Reader:
    """Random-access reader with automatic per-field decode."""

    def __init__(self, loadpath: str, mode: str = "r"):
        self._file = _h5py().File(loadpath, mode=mode)
        self.encode_fns = decode_generic(self._file.attrs["encode_fns"][()])
        self.decode_fns = decode_generic(self._file.attrs["decode_fns"][()])
        self.fields = list(self._file.keys())
        self.sizes = {key: self._file[key].shape[0] for key in self.fields}

    def __len__(self):
        return max(self.sizes.values()) if self.sizes else 0

    def get(self, field: str, idx):
        x = self._file[field][idx]
        decode_fn = self.decode_fns.get(field)
        if decode_fn is not None:
            if isinstance(idx, slice):
                x = np.stack([decode_fn(xi) for xi in x])
            else:
                x = decode_fn(x)
        return x

    def load_all(self):
        return {key: list(self._file[key][:]) for key in self.fields}

    def __getitem__(self, idx):
        return {key: self.get(key, idx) for key in self.fields}


class H5Modifier(H5Reader):
    def __init__(self, loadpath: str):
        super().__init__(loadpath, mode="a")


class RemoteWriter(H5Writer):
    """Sharding writer: local split files of split_size rows, uploaded on
    rollover to ``{savepath}/{timestamp}-w{process}-{rand}.hdf5``.

    savepath may be local (files land there directly) or gs:// (split files
    upload through utils/filesystem.py and the local temp file is deleted).
    ``tmpdir`` defaults to the system's temporary directory.
    """

    def __init__(self, savepath: str, split_size: int = 1000, tmpdir: Optional[str] = None):
        import tempfile

        self._remote = fs.is_remote(savepath)
        self._savepath = savepath
        self._split_size = int(split_size)
        self._tmpdir = tmpdir or tempfile.gettempdir()
        self._worker = process_index()
        if not self._remote:
            os.makedirs(savepath, exist_ok=True)
        self._update_paths()
        super().__init__(self._local_path)

    def __len__(self):
        return max(self._sizes.values()) if self._sizes else 0

    def _update_paths(self) -> None:
        fname = f"{timestamp()}-w{self._worker}-{randstr()}.hdf5"
        if self._remote:
            self._local_path = os.path.join(self._tmpdir, fname)
            self._remote_path = os.path.join(self._savepath, fname)
        else:
            self._local_path = os.path.join(self._savepath, fname)
            self._remote_path = None

    def configure(self, field: str, **kwargs) -> None:
        super().configure(field, max_size=self._split_size, **kwargs)

    def _schema(self):
        return {
            field: (self._vlens[field], self._encode_fns[field], self._decode_fns[field])
            for field in self._sizes
        }

    def _restore_schema(self, schema) -> None:
        for field, (vlen, enc, dec) in schema.items():
            self.configure(field, vlen=vlen, encode_fn=enc, decode_fn=dec)

    def add(self, *args, **kwargs) -> None:
        super().add(*args, **kwargs)
        if all(size >= self._split_size for size in self._sizes.values()):
            schema = self._schema()
            self._close_split()
            self._update_paths()
            self._make_file(self._local_path)
            self._restore_schema(schema)

    def _close_split(self) -> None:
        super().close()
        if self._remote:
            fs.put_file(self._local_path, self._remote_path)
            os.remove(self._local_path)

    def close(self) -> None:
        if len(self):
            self._close_split()
        else:
            self._file.close()
            if os.path.exists(self._local_path):
                os.remove(self._local_path)


def make_weights(labels: np.ndarray, temperature: float,
                 prompts: Optional[np.ndarray] = None) -> np.ndarray:
    """Softmax RWR weights over all ``labels`` with mean 1; with ``prompts``,
    the softmax runs within each prompt's samples (mean 1 within each)
    (reference: utils/hdf5.py:437-461)."""
    if prompts is None:
        return softmax_ref(labels, temperature=temperature) * len(labels)
    weights = np.empty_like(labels, dtype=np.float64)
    for prompt in np.unique(prompts):
        mask = prompts == prompt
        weights[mask] = softmax_ref(labels[mask], temperature=temperature) * mask.sum()
    return weights


class _MultiFileReader:
    """Base for readers over many split files with a global index map."""

    def _build_index(self, sizes_per_file) -> None:
        total = sum(sizes_per_file)
        self._idx2file = np.zeros(total, dtype=np.int64)
        self._idx2idx = np.zeros(total, dtype=np.int64)
        start = 0
        for fid, size in enumerate(sizes_per_file):
            self._idx2file[start : start + size] = fid
            self._idx2idx[start : start + size] = np.arange(size)
            start += size
        self._total_size = total

    def __len__(self):
        return self._total_size

    def get(self, idx, field: str = "images"):
        if isinstance(idx, slice):
            return np.stack(
                [self.get(i, field=field) for i in _slice2range(idx)], axis=0
            )
        fid = self._idx2file[idx]
        local_idx = self._idx2idx[idx]
        file = self._get_file(fid)
        x = file[field][local_idx]
        decode_fn = self.decode_fns.get(field)
        if decode_fn is not None:
            x = decode_fn(x)
        return x

    def __getitem__(self, idx):
        batch = {key: self.get(idx, field=key) for key in self.fields}
        if getattr(self, "weighted", False):
            batch["weights"] = self.weights[idx]
        return batch

    def make_weights(self, field: str, temperature: float, by_prompt: bool) -> None:
        """Softmax RWR weights over the whole dataset (``make_weights``),
        optionally per prompt. Weights have mean 1."""
        labels = np.asarray(self.get(slice(0, len(self)), field)).squeeze()
        prompts = None
        if by_prompt:
            prompts = np.asarray(self.get(slice(0, len(self)), "inference_prompts")).squeeze()
        self.weights = make_weights(labels, temperature, prompts)
        self.weighted = True
        cumsum = np.cumsum(np.sort(self.weights)[::-1] / len(self))
        n = int(((cumsum <= 0.9) * np.arange(len(cumsum))).max())
        print(
            f"[ data/hdf5 ] {n}/{len(cumsum)} samples carry 90% of the RWR "
            f"weight (temperature {temperature})"
        )


class RemoteReader(_MultiFileReader):
    """Manifest-driven reader: sizes.pkl maps file -> row count; one split
    file is kept open at a time (reference: utils/hdf5.py:352-461)."""

    def __init__(self, loadpath: str):
        self._loadpath = loadpath
        self.weighted = False
        self._current_fid = None
        self._current_file = None

        sizes = fs.unpickle(os.path.join(loadpath, "sizes.pkl"))
        self._paths = sorted(sizes.keys())
        self._build_index([sizes[p] for p in self._paths])
        # schema from the first file
        first = self._open(self._paths[0])
        self.fields = list(first.keys())
        self.decode_fns = decode_generic(first.attrs["decode_fns"][()])
        self.encode_fns = decode_generic(first.attrs["encode_fns"][()])
        self._current_fid, self._current_file = 0, first

    def _open(self, path: str):
        full = path if os.path.isabs(path) or fs.is_remote(path) else os.path.join(
            self._loadpath, path
        )
        if fs.is_remote(full):
            return _h5py().File(fs.open(full, mode="rb"), "r")
        return _h5py().File(full, "r")

    def _get_file(self, fid: int):
        if fid != self._current_fid:
            self._current_file = self._open(self._paths[fid])
            self._current_fid = fid
        return self._current_file


class SlowRemoteReader(_MultiFileReader):
    """Manifest-less: list *.hdf5 under loadpath and open all up front."""

    def __init__(self, loadpath: str):
        self.weighted = False
        if fs.is_remote(loadpath):
            names = [n for n in fs.ls(loadpath, strip=False) if n.endswith(".hdf5")]
            paths = [f"gs://{n}" if not n.startswith("gs://") else n for n in names]
        else:
            paths = sorted(glob.glob(os.path.join(loadpath, "*.hdf5")))
        self._files = []
        for p in paths:
            if fs.is_remote(p):
                self._files.append(_h5py().File(fs.open(p, mode="rb"), "r"))
            else:
                self._files.append(_h5py().File(p, "r"))
        assert self._files, f"no .hdf5 files under {loadpath}"
        self.fields = list(self._files[0].keys())
        self.decode_fns = decode_generic(self._files[0].attrs["decode_fns"][()])
        self.encode_fns = decode_generic(self._files[0].attrs["encode_fns"][()])
        self._build_index([f[self.fields[0]].shape[0] for f in self._files])

    def _get_file(self, fid: int):
        return self._files[fid]

    def load_all(self):
        batch = defaultdict(list)
        for file in self._files:
            for key in file.keys():
                batch[key].extend(file[key][:])
        return batch


class LocalReader(SlowRemoteReader):
    pass


def write_images(reader, savepath: str, limit: Optional[int] = None) -> int:
    """Export a dataset's decoded images as PNGs (reference:
    H5Writer.write_images, utils/hdf5.py:196-204). Works with any reader."""
    from ddpo_torch.utils.images import save_image

    worker = process_index()
    n = len(reader) if limit is None else min(limit, len(reader))
    for i in range(n):
        save_image(os.path.join(savepath, f"{worker}_{i}.png"), reader[i]["images"])
    return n
