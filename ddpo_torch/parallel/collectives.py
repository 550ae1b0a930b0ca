"""Cross-process reductions and consistency checks over torch.distributed.

Port of ddpo_tpu/parallel/collectives.py. The default process group is
gloo (parallel/mesh.py ``maybe_initialize_distributed``), so the host-side
helpers work on any device; with no group up every helper is the
one-process identity:

  - ``process_index`` / ``process_count``: the rank and the world size;
  - ``worker_sum``: the sum of a scalar (or a numpy array) over processes;
  - ``sharded_softmax``: softmax over the concatenation of every rank's
    vector, from the global max and the global sum (``softmax_ref`` of the
    concatenation);
  - ``all_gather_array`` / ``all_gather_strings``: every rank's rows, in
    rank order (JAX pads prompts into bytes because its collectives refuse
    strings; ``all_gather_object`` over gloo takes them as they are);
  - ``digest`` and ``all_processes_equal``: a digest of a tree of tensors,
    arrays and scalars (bit-exact: tensors are hashed through their integer
    view), gathered, raising when the ranks disagree;
  - ``process_barrier``;
  - ``GradientAllReduce``: the gradients' mean (or sum) over ranks in flat
    buckets, optionally in a reduced dtype (``--grad_reduce_dtype``);
  - ``sync_state_across_devices``: rank 0's tensors broadcast to every rank.

Gloo reduces host memory: its CUDA entry points copy each tensor to the
host internally. Where a bucket on a card goes through gloo (ranks sharing
a card), it is staged through a pinned host buffer here, on purpose, so
that the copy is this one, timed with the reduce, whichever CUDA dtypes
the build's gloo takes. NCCL reduces on the cards.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 256 * 2**20

_INT_VIEW = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def worker_sum(value, group=None):
    """The sum over processes (of ``group``, default all) of a scalar (a
    float back) or of a numpy array (an array back), reduced in float64 on
    the host."""
    if process_count() == 1:
        return float(value) if np.ndim(value) == 0 else np.asarray(value)
    t = torch.as_tensor(np.asarray(value, dtype=np.float64)).reshape(-1).clone()
    dist.all_reduce(t, group=group)
    out = t.numpy().reshape(np.shape(value))
    return float(out) if np.ndim(value) == 0 else out


def softmax_ref(x: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """Sequential oracle (reference: utils/array.py:32-41). The logits are
    multiplied by ``temperature``."""
    assert x.ndim == 1
    x = x * temperature
    z = x - x.max()
    numer = np.exp(z)
    return numer / numer.sum()


def _reduce_scalar(value: torch.Tensor, op) -> torch.Tensor:
    host = value.detach().reshape(1).to("cpu", copy=True)
    dist.all_reduce(host, op=op)
    return host.to(value.device)[0]


def sharded_softmax(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """softmax(x * temperature) over the concatenation of every rank's
    vector; each rank gets its own entries back."""
    z = x * temperature
    if process_count() == 1:
        numer = torch.exp(z - z.max())
        return numer / numer.sum()
    numer = torch.exp(z - _reduce_scalar(z.max(), dist.ReduceOp.MAX))
    return numer / _reduce_scalar(numer.sum(), dist.ReduceOp.SUM)


def _gather_objects(obj, group=None) -> list:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_array(x: np.ndarray, group=None) -> np.ndarray:
    """Every rank's (of ``group``, default all) rows of ``x``, concatenated
    in rank order (JAX's ``process_allgather(x, tiled=True)``)."""
    if process_count() == 1:
        return np.asarray(x)
    return np.concatenate([np.asarray(p) for p in _gather_objects(np.asarray(x), group)])


def all_gather_strings(strings, group=None) -> List[str]:
    """Every rank's (of ``group``, default all) strings, in rank order."""
    if process_count() == 1:
        return list(strings)
    return [s for part in _gather_objects([str(s) for s in strings], group) for s in part]


def _tensor_sums(t: torch.Tensor) -> torch.Tensor:
    """Three int64 sums of a tensor's bits (plain, squared, by position;
    wrapping), computed where the tensor lives."""
    t = t.detach()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    v = t.contiguous().view(_INT_VIEW[t.element_size()]).reshape(-1).to(torch.int64)
    pos = torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.int64)
    return torch.stack([v.sum(), (v * v).sum(), (v * pos).sum()])


def digest(tree) -> str:
    """A digest of a nested dict/list of tensors, arrays and scalars that
    changes with any bit of any leaf (tensors are reduced where they live,
    so the digest of a card's parameters moves only 24 bytes a tensor to
    the host)."""
    h = hashlib.sha256()
    sums = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif isinstance(x, torch.Tensor):
            h.update(f"{path}:{x.dtype}:{tuple(x.shape)}".encode())
            sums.append(_tensor_sums(x) if x.numel() else torch.zeros(3, dtype=torch.int64))
        elif isinstance(x, np.ndarray):
            h.update(f"{path}:{x.dtype}:{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(f"{path}:{x!r}".encode())

    walk(tree, "")
    if sums:  # one copy to the host
        h.update(torch.stack([s.to(sums[0].device) for s in sums]).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def all_processes_equal(tree, name: str = "tree") -> str:
    """Raise unless every rank holds the same ``tree`` (by ``digest``);
    returns the digest."""
    d = digest(tree)
    if process_count() > 1:
        digests = _gather_objects(d)
        if len(set(digests)) > 1:
            raise RuntimeError(f"{name} diverged across processes: digests by rank {digests}")
    return d


def process_barrier(name: str) -> None:
    """Align every process (gloo barrier on the default group). ``name``
    says which boundary, for the traceback of a rank that never came."""
    del name
    if process_count() > 1:
        dist.barrier()


def _buckets(tensors: Dict[str, torch.Tensor], dtype: Optional[torch.dtype],
             bucket_bytes: int) -> Iterator[List[str]]:
    """Names in order, cut into runs of one dtype of at most about
    ``bucket_bytes`` each (a tensor larger than that is a bucket alone)."""
    run, run_bytes, run_dtype = [], 0, None
    for name, t in tensors.items():
        dt = dtype or t.dtype
        nbytes = t.numel() * torch.empty((), dtype=dt).element_size()
        if run and (dt != run_dtype or run_bytes + nbytes > bucket_bytes):
            yield run
            run, run_bytes = [], 0
        run.append(name)
        run_bytes += nbytes
        run_dtype = dt
    if run:
        yield run


class _Collective:
    """One collective on a flat bucket, over ``group`` with ``backend``;
    buckets on a card going through gloo are staged through a pinned host
    buffer (module docstring)."""

    def __init__(self, group, backend: str):
        self.group, self.backend = group, backend
        self._pinned: Dict[torch.dtype, torch.Tensor] = {}  # one buffer a dtype, reused

    def __call__(self, flat: torch.Tensor, fn) -> None:
        if not (flat.is_cuda and self.backend == "gloo"):
            fn(flat, group=self.group)
            return
        buf = self._pinned.get(flat.dtype)
        if buf is None or buf.numel() < flat.numel():
            buf = self._pinned[flat.dtype] = torch.empty(flat.numel(), dtype=flat.dtype,
                                                         pin_memory=True)
        # the stream orders this copy after the previous bucket's copy back
        host = buf[:flat.numel()]
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        fn(host, group=self.group)
        flat.copy_(host, non_blocking=True)


def _sync(tensors) -> None:
    t = next(iter(tensors), None)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class GradientAllReduce:
    """The mean (or sum) over ranks of each rank's gradients, in place.

    Called once per optimizer step, after accumulation and before the
    global-norm clip (training/policy_gradient.py ``AccumulatingTrainState``).
    The gradients are cast to ``reduce_dtype`` (None: their own dtype) into
    flat buckets of about ``bucket_bytes``, summed across ranks, divided by
    ``divisor`` (default the world size) for "mean", and cast back into the
    gradient tensors. Under spatial sharding each sp rank holds a partial
    gradient, so the mean over dp is the sum over the world divided by dp:
    ``divisor=dp``. The rest is
    JAX's ``grad_reduce_dtype`` (ddpo_tpu/training/policy_gradient.py
    local_grads) with fp32 the GSPMD global-batch mean. ``calls`` keeps
    (bytes moved per rank, seconds) of each call, the card synchronized
    before and after.
    """

    def __init__(self, group, backend: str, reduce_dtype: Optional[torch.dtype] = None,
                 bucket_bytes: int = BUCKET_BYTES, divisor: Optional[int] = None):
        self.collective = _Collective(group, backend)
        self.backend = backend
        self.reduce_dtype = reduce_dtype
        self.bucket_bytes = bucket_bytes
        self.world = dist.get_world_size(group) if _initialized() else 1
        self.divisor = divisor or self.world
        self.calls: List[tuple] = []

    @torch.no_grad()
    def __call__(self, grads: Dict[str, torch.Tensor], op: str = "mean"
                 ) -> Dict[str, torch.Tensor]:
        assert op in ("mean", "sum"), op
        _sync(grads.values())
        start, nbytes = time.perf_counter(), 0
        for names in _buckets(grads, self.reduce_dtype, self.bucket_bytes):
            dtype = self.reduce_dtype or grads[names[0]].dtype
            flat = torch.cat([grads[k].reshape(-1).to(dtype) for k in names])
            nbytes += flat.numel() * flat.element_size()
            if self.world > 1:  # one process: the cast to reduce_dtype and back alone
                self.collective(flat, dist.all_reduce)
                if op == "mean":
                    flat.div_(self.divisor)
            offset = 0
            for k in names:
                n = grads[k].numel()
                grads[k].copy_(flat[offset:offset + n].view_as(grads[k]))
                offset += n
        _sync(grads.values())
        self.calls.append((nbytes, time.perf_counter() - start))
        return grads


@torch.no_grad()
def sync_state_across_devices(tensors: Dict[str, torch.Tensor], group=None,
                              backend: str = "gloo",
                              bucket_bytes: int = BUCKET_BYTES) -> Dict[str, torch.Tensor]:
    """Broadcast rank 0's tensors to every rank, in place (JAX's
    replicated device_put of one host copy; the reference's psum-select,
    utils/array.py:8-15)."""
    if process_count() == 1:
        return tensors
    collective = _Collective(group, backend)
    for names in _buckets(tensors, None, bucket_bytes):
        flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
        collective(flat, lambda t, group: dist.broadcast(t, src=0, group=group))
        offset = 0
        for k in names:
            n = tensors[k].numel()
            tensors[k].copy_(flat[offset:offset + n].view_as(tensors[k]))
            offset += n
    _sync(tensors.values())
    return tensors
