"""Transparent local / gs:// filesystem layer.

Same surface as the reference's ddpo/utils/filesystem.py (open/ls/exists/
save/unpickle/rm/save_json/read_json/get_bucket/join_and_create), with gcsfs
imported lazily so local-only runs work without GCS credentials, plus
recursive put_dir/get_dir used by the per-epoch artifact sync
(reference async_to_bucket, utils/serialization.py:383-399).

Set DDPO_TPU_FAKE_GCS=<dir> to map gs:// paths onto a local directory — the
zero-egress test environment's way of exercising every remote code path
(artifact sync, remote checkpoints, RemoteWriter uploads) end-to-end.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
from typing import Callable, Optional

builtin_open = open


def _fake_root() -> str | None:
    return os.environ.get("DDPO_TPU_FAKE_GCS") or None


def _fake_path(path: str) -> str:
    return os.path.join(_fake_root(), path.split("gs://", 1)[1])


def _gcs():
    import gcsfs

    return gcsfs.GCSFileSystem()


def is_remote(path: str) -> bool:
    return "gs://" in path


def open(path: str, bucket: str | None = None, mode: str = "rb"):
    if bucket is not None:
        bucket = bucket if bucket.startswith("gs://") else "gs://" + bucket
        path = os.path.join(bucket, path)
    if is_remote(path):
        if _fake_root():
            local = _fake_path(path)
            if "w" in mode or "a" in mode:
                os.makedirs(os.path.dirname(local), exist_ok=True)
            return builtin_open(local, mode=mode)
        return _gcs().open(path, mode=mode)
    return builtin_open(path, mode=mode)


def ls(path: str, bucket: str | None = None, strip: bool = True):
    if bucket is not None:
        bucket = bucket if bucket.startswith("gs://") else "gs://" + bucket
        path = os.path.join(bucket, path)
    if is_remote(path):
        if _fake_root():
            return sorted(os.listdir(_fake_path(path)))
        paths = sorted(_gcs().ls(path))
        if strip:
            paths = ["/".join(p.split("/")[1:]) for p in paths]
        return paths
    return sorted(os.listdir(path))


def exists(path: str) -> bool:
    if is_remote(path):
        if _fake_root():
            return os.path.exists(_fake_path(path))
        return _gcs().exists(path)
    return os.path.exists(path)


def put_file(local: str, remote: str) -> None:
    """Upload one local file to a remote (or fake-remote) path."""
    if _fake_root() or not is_remote(remote):
        dest = _fake_path(remote) if is_remote(remote) else remote
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(local, dest)
        return
    _gcs().put(local, remote)


# per-(local, remote) registry of what this process already uploaded:
# rel path -> (mtime, size) at upload time. Change detection compares the
# LOCAL clock against itself, so it is immune to host-vs-GCS clock skew and
# to the write-during-in-flight-sync race that comparing getmtime against
# the remote object's 'updated' timestamp suffers (a file rewritten while
# its previous version was uploading would otherwise be skipped forever).
_UPLOADED: dict = {}


def put_dir(local: str, remote: str, only_newer: bool = True,
            exclude: Optional[Callable[[str], bool]] = None) -> int:
    """Recursively upload local -> remote; returns the file count copied.

    only_newer skips files unchanged since this process last uploaded them
    (cheap incremental sync, the gsutil-rsync equivalent of the reference's
    async_to_bucket). The first sync of a process uploads everything once —
    O(run artifacts) per restart, vs O(epochs^2) for unconditional re-upload
    over a long run (reference uses gsutil rsync, serialization.py:383-399).
    ``exclude(rel_path)`` skips the files it is true for.
    """
    copied = 0
    seen = _UPLOADED.setdefault((os.path.abspath(local), remote), {})
    for root, _, files in os.walk(local):
        for f in files:
            src = os.path.join(root, f)
            rel = os.path.relpath(src, local)
            if exclude is not None and exclude(rel):
                continue
            stamp = (os.path.getmtime(src), os.path.getsize(src))
            if only_newer and seen.get(rel) == stamp:
                continue
            put_file(src, os.path.join(remote, rel))
            seen[rel] = stamp
            copied += 1
    return copied


def get_dir(remote: str, local: str) -> int:
    """Recursively download remote -> local; returns the file count."""
    copied = 0
    if _fake_root() or not is_remote(remote):
        base = _fake_path(remote) if is_remote(remote) else remote
        if not os.path.isdir(base):
            return 0
        for root, _, files in os.walk(base):
            for f in files:
                src = os.path.join(root, f)
                rel = os.path.relpath(src, base)
                dest = os.path.join(local, rel)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                shutil.copy2(src, dest)
                copied += 1
        return copied
    gcs = _gcs()
    if not gcs.exists(remote):
        return 0
    gcs.get(remote, local, recursive=True)
    return 1


def save(path: str, x) -> None:
    with open(path, mode="wb") as f:
        pickle.dump(x, f)


def unpickle(path: str):
    with open(path, mode="rb") as f:
        return pickle.load(f)


def rm(path: str) -> None:
    assert not is_remote(path)
    shutil.rmtree(path)


def save_json(path: str, x) -> None:
    with open(path, mode="w") as f:
        json.dump(x, f)


def read_json(path: str):
    with open(path, mode="r") as f:
        return json.load(f)


def get_bucket(path: str):
    """Split 'gs://bucket/rest' -> ('bucket', 'rest')."""
    matched = re.match("gs://.+?/", path)
    assert matched is not None, f"expected a gs:// bucket in {path}"
    start, end = matched.span()
    bucket = path[start:end].replace("gs://", "").replace("/", "")
    return bucket, path[end:]


def join_and_create(*args: str) -> str:
    """os.path.join that creates parent directories."""
    path = os.path.join(*args)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def mkdir(savepath: str, fname: bool = False) -> bool:
    """Create directory (optionally the parent of a file path)."""
    if fname:
        savepath = os.path.split(savepath)[0]
    if savepath and not os.path.exists(savepath):
        os.makedirs(savepath)
        return True
    return False
