"""Build the sizes.pkl manifest for a sampled dataset directory.

Port of ddpo_tpu/pipelines/save_sizes.py: a thread pool opens each split
file and reads its row count (h5py reads only metadata here, so threads
suffice and errors propagate); the manifest maps file name -> rows and is
what data/hdf5.py's ``RemoteReader`` indexes by.

Run: python -m ddpo_torch.pipelines.save_sizes --dataset compressed-animals-rwr
"""

from __future__ import annotations

import os
from concurrent import futures

from ddpo_torch.parallel.collectives import process_index
from ddpo_torch.utils import fs
from ddpo_torch.utils.parser import Parser as BaseParser


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals_rwr"


def file_size(loadpath: str, fname: str) -> int:
    import h5py

    full = fname if fs.is_remote(fname) else os.path.join(loadpath, fname)
    handle = fs.open(full, mode="rb") if fs.is_remote(full) else full
    with h5py.File(handle, "r") as f:
        field = next(iter(f.keys()))
        return int(f[field].shape[0])


def build_manifest(loadpath: str, max_workers: int = 16) -> dict:
    fnames = [f for f in fs.ls(loadpath) if f.endswith(".hdf5")]
    print(f"[ sizes ] {len(fnames)} files under {loadpath}")
    with futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
        sizes = list(pool.map(lambda f: file_size(loadpath, f), fnames))
    manifest = dict(zip(fnames, sizes))
    print(f"[ sizes ] total {sum(sizes)} entries")
    return manifest


def main(argv=None) -> dict:
    args = Parser().parse_args("sizes", argv, setup=False)
    loadpath = getattr(args, "override", None) or args.loadpath
    if hasattr(args, "logbase") and not (
        loadpath.startswith("/") or fs.is_remote(loadpath)
    ):
        loadpath = os.path.join(args.logbase, loadpath)
    manifest = build_manifest(loadpath)
    if process_index() == 0:
        fs.save(os.path.join(loadpath, "sizes.pkl"), manifest)
    return manifest


if __name__ == "__main__":
    main()
