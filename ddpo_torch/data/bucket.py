"""RWR training dataset + loader over the HDF5 readers.

Port of ddpo_tpu/data/bucket.py (numpy batches; the finetune driver moves
them to the device). A thread-prefetching iterator in place of the
reference's torch DataLoader (ddpo/datasets/bucket.py): HDF5 reads overlap
with the device's steps. Semantics preserved:
  - per-host contiguous sharding (host i takes rows [i*N/H, (i+1)*N/H)),
  - manual shuffle permutation, subsample, per-sample transform,
  - collate: stack VAE moments, tokenize captions + the uncond prompt to the
    fixed CLIP length, carry reward fields and idx provenance, drop_last.
"""

from __future__ import annotations

import queue
import random
import threading
from functools import partial
from typing import Callable, Optional

import numpy as np

from ddpo_torch.parallel.collectives import process_count, process_index

CALLBACK_FIELDS = ("aesthetic", "consistency", "jpeg", "labels", "weights")


class BucketDataset:
    def __init__(self, reader):
        self.reader = reader
        self.transform_fn = lambda x: x
        self._max_size: Optional[int] = None
        self._offset = 0
        self._shuffled = np.arange(len(reader))

    def __len__(self):
        return self._max_size or len(self.reader)

    def __getitem__(self, idx: int):
        worker_idx = self._offset + idx
        shuffled_idx = int(self._shuffled[worker_idx])
        x = self.reader[shuffled_idx]
        x = self.transform_fn(x)
        x["idx"] = worker_idx
        x["shuffled_idx"] = shuffled_idx
        return x

    def shuffle(self) -> None:
        self._shuffled = np.random.permutation(self._shuffled)

    def shard(self) -> None:
        host_id = process_index()
        n_hosts = process_count()
        per_host = len(self) // n_hosts
        self._max_size = per_host
        self._offset = host_id * per_host

    def subsample(self, n: int) -> None:
        self._max_size = n

    def with_transform(self, transform_fn: Callable) -> None:
        self.transform_fn = transform_fn

    def make_weights(self, *args, **kwargs) -> None:
        self.reader.make_weights(*args, **kwargs)


def select_caption(example: dict, field: str = "training_prompts") -> dict:
    caption = example.get(field)
    if isinstance(caption, (list, tuple, np.ndarray)):
        caption = random.choice(list(caption))
    if isinstance(caption, bytes):
        caption = caption.decode()
    example["text"] = caption
    return example


def make_uncond_text(tokenizer, batch_size: int) -> np.ndarray:
    return tokenizer([""] * batch_size)


def collate_fn(tokenizer, examples, image_field="vae", text_field="input_ids"):
    pixel_values = np.stack([e[image_field] for e in examples]).astype(np.float32)
    captions = [e["text"] for e in examples]

    callback_labels = {
        key: np.stack([e[key] for e in examples])
        for key in CALLBACK_FIELDS
        if key in examples[0]
    }

    batch = {
        image_field: pixel_values,
        text_field: tokenizer(captions),
        "idxs": np.stack([e["idx"] for e in examples]),
        "shuffled_idxs": np.stack([e["shuffled_idx"] for e in examples]),
        "uncond_text": make_uncond_text(tokenizer, len(examples)),
        **callback_labels,
    }
    return batch


class PrefetchLoader:
    """Batched iterator with a background prefetch thread (depth-bounded)."""

    def __init__(self, dataset, batch_size: int, collate, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        n_batches = len(self)

        def producer():
            try:
                for b in range(n_batches):
                    start = b * self.batch_size
                    end = min(start + self.batch_size, len(self.dataset))
                    examples = [self.dataset[i] for i in range(start, end)]
                    q.put(self.collate(examples))
            except Exception as e:  # surface reader errors to the consumer
                q.put(e)
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item


def get_bucket_loader(
    loadpath: str,
    tokenizer,
    batch_size: int,
    resolution: Optional[int] = None,
    max_train_samples: Optional[int] = None,
    num_workers: int = 2,
):
    """Reader selection mirrors the reference (datasets/bucket.py:118-150):
    manifest-driven RemoteReader when sizes.pkl exists, else scan files."""
    import os

    from ddpo_torch.data.hdf5 import LocalReader, RemoteReader
    from ddpo_torch.utils import filesystem as fs

    del resolution
    manifest = os.path.join(loadpath, "sizes.pkl")
    if fs.exists(manifest):
        reader = RemoteReader(loadpath)
    else:
        reader = LocalReader(loadpath)
    return bucket_loader(reader, tokenizer, batch_size, max_train_samples, num_workers)


def bucket_loader(reader, tokenizer, batch_size: int,
                  max_train_samples: Optional[int] = None, num_workers: int = 2):
    """(dataset, loader) over any reader: subsample, caption selection,
    sharding, and the prefetching collate loader (drop_last)."""
    dataset = BucketDataset(reader)
    if max_train_samples is not None:
        dataset.subsample(max_train_samples)
    dataset.with_transform(select_caption)
    dataset.shard()

    loader = PrefetchLoader(
        dataset,
        batch_size=batch_size,
        collate=partial(collate_fn, tokenizer),
        drop_last=True,
        prefetch=max(1, num_workers),
    )
    return dataset, loader
