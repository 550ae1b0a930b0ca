"""Parameter partition rules over the mesh's tp axis, and the train state's
slices and gathers.

Port of ddpo_tpu/parallel/sharding.py. The rules are JAX's ``_TP_RULES``
over the port's state-dict names and its (out, in) Linear layout:

  - column-parallel, weight dim 0 and bias dim 0: the attention projections
    to_q / to_k / to_v (q_proj / k_proj / v_proj), the GEGLU's
    ``ff.net.0.proj`` and the MLP's fc1;
  - row-parallel, weight dim 1, bias replicated: to_out.0 (out_proj),
    ``ff.net.2`` and fc2;
  - everything else (convs, norms, the time embedding) replicates.

JAX shards a parameter's *global* layout contiguously and lets GSPMD
reshard where a layer needs another layout. The port has no GSPMD: a rank
holds the slices its layers compute with. That differs from JAX's in one
place, the GEGLU: ``ff.net.0.proj``'s output is [hidden | gate] and the
layer splits it in two (models/layers.py ``GEGLU``), so rank r holds rows
``hidden[r]`` and ``gate[r]`` (``Shard.halves`` = 2), and ``ff.net.2``'s
input columns r, which meet ``hidden[r]``. ``gather_state_dict`` puts the
halves back in JAX's global order.

A ``Shard`` names the split dim of one tensor. ``param_specs`` gives each
parameter its Shard (or None: replicated); ``shard_state_dict`` takes this
rank's slices of a whole state dict, ``gather_state_dict`` all-gathers the
slices over the tp group into the whole one, and ``shard_module`` shards a
built module (the UNet) in place and marks its tp layers.
``TensorParallel`` carries the specs and the tp axis to the optimizers'
whole-tensor reductions (training/optim.py) and to the train state's
``state_dict`` / ``load_state_dict`` (training/policy_gradient.py), which
write and read the gathered global state, so a checkpoint is the same at
any tp. An optimizer moment takes its parameter's Shard
(``place_train_state``'s rule); a factored adafactor statistic reduced
over the split dim is replicated (JAX replicates every such leaf; here the
one reduced over another dim keeps the split on its remaining dims).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ddpo_torch.ops.spatial import Axis, all_gather, all_reduce

# (regex over the port's parameter name, the split dim)
_TP_RULES = [
    # Linear weights (out, in): column-parallel, split out
    (r"(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight$", 0),
    (r"(ff\.net\.0\.proj|fc1)\.weight$", 0),
    # row-parallel, split in
    (r"(to_out\.0|out_proj|ff\.net\.2|fc2)\.weight$", 1),
    # biases of the column-parallel layers
    (r"(to_q|to_k|to_v|q_proj|k_proj|v_proj|ff\.net\.0\.proj|fc1)\.bias$", 0),
]
# the GEGLU projection: its output rows are [hidden | gate]
_HALVES = r"ff\.net\.0\.proj\.(weight|bias)$"


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor split over the tp group along ``dim``; with ``halves`` = 2
    the dim is [first | second] and each half splits apart (the GEGLU)."""

    dim: int
    halves: int = 1

    def local(self, t: torch.Tensor, size: int, index: int) -> torch.Tensor:
        """Rank ``index``'s slice of the whole ``t`` (a view)."""
        if t.shape[self.dim] % (self.halves * size):
            raise ValueError(f"dim {self.dim} of {tuple(t.shape)} does not split over tp={size}"
                             + (" in each half" if self.halves > 1 else ""))
        parts = t.unflatten(self.dim, (self.halves, size, -1)).select(self.dim + 1, index)
        return parts.flatten(self.dim, self.dim + 1)

    def join(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's slice, in rank order."""
        halves = [p.unflatten(self.dim, (self.halves, -1)) for p in parts]
        return torch.stack(halves, self.dim + 1).flatten(self.dim, self.dim + 2)

    def drop(self, axis: int) -> Optional["Shard"]:
        """The Shard of this tensor reduced over ``axis``: None (replicated)
        when that is the split dim."""
        if axis == self.dim:
            return None
        return Shard(self.dim - (self.dim > axis), self.halves)


def unet_partition_rules(name: str, ndim: int) -> Optional[Shard]:
    """The Shard of parameter ``name`` (None: replicated)."""
    for pattern, dim in _TP_RULES:
        if re.search(pattern, name) and dim < ndim:
            return Shard(dim, 2 if re.search(_HALVES, name) else 1)
    return None


def param_specs(params: Mapping[str, torch.Tensor]) -> Dict[str, Optional[Shard]]:
    """Each parameter's Shard, by the rules."""
    return {k: unet_partition_rules(k, p.dim()) for k, p in params.items()}


def shard_state_dict(state: Mapping[str, torch.Tensor], size: int, index: int,
                     specs: Optional[Mapping[str, Optional[Shard]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s slices (of ``size``) of a whole state dict; the
    replicated entries as they are."""
    specs = param_specs(state) if specs is None else specs
    return {k: t if specs.get(k) is None else specs[k].local(t, size, index)
            for k, t in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], axis: Axis,
                      specs: Mapping[str, Optional[Shard]]) -> Dict[str, torch.Tensor]:
    """The whole state dict, in JAX's global layout, from each rank's slices
    (every rank of the group calls it, in the same order); the replicated
    entries as they are."""
    if axis.size == 1:
        return dict(state)
    return {k: t if specs.get(k) is None else specs[k].join(all_gather(t.detach(), axis,
                                                                       "tp_state"))
            for k, t in state.items()}


def shard_module(module: nn.Module, axis: Optional[Axis]) -> nn.Module:
    """Shard a built module's parameters over ``axis`` in place, and mark
    its tp layers: every submodule with a ``tp`` field gets the axis (the
    attention and feed-forward blocks, models/layers.py), and a Linear whose
    weight splits gets it with ``row_parallel`` when its input dim splits.
    An axis of size 1 (or None) leaves the module as it is. Returns it."""
    if axis is None or axis.size == 1:
        return module
    specs = param_specs(dict(module.named_parameters()))
    with torch.no_grad():
        for name, spec in specs.items():
            if spec is None:
                continue
            path, _, leaf = name.rpartition(".")
            owner = module.get_submodule(path)
            p = getattr(owner, leaf)
            local = spec.local(p.detach(), axis.size, axis.index).clone()
            setattr(owner, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
    for path, m in module.named_modules():
        if not hasattr(m, "tp"):
            continue
        if hasattr(m, "row_parallel"):  # a Linear
            spec = specs.get(f"{path}.weight")
            if spec is None:
                continue
            m.row_parallel = spec.dim == 1
        m.tp = axis
    return module


class TensorParallel:
    """The tp layout of a train state: the tp axis and each parameter's
    Shard. ``psum`` is the sum over the group (fp32, the result equal on
    every rank); ``partial_mean`` and ``finish_means`` give whole tensors'
    means from this rank's slices, with one all-reduce for a whole list;
    ``gather`` / ``local`` the whole tensors and this rank's slices, and
    ``global_shape`` a parameter's whole shape."""

    def __init__(self, axis: Axis, specs: Mapping[str, Optional[Shard]]):
        self.axis, self.specs = axis, dict(specs)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t.float(), self.axis, "tp_optim")

    def sharded(self, name: str) -> bool:
        return self.specs.get(name) is not None

    def partial_mean(self, x: torch.Tensor, spec: Optional[Shard], dim: Optional[int] = None,
                     keepdim: bool = False) -> Tuple[torch.Tensor, Optional[int]]:
        """The first half of the mean of the whole tensor whose slice is
        ``x`` (``spec`` its Shard), over ``dim`` or over all elements:
        (the mean, None) when it is this rank's to take, and (this rank's
        sum, the whole count) when the reduction runs over the split dim."""
        if spec is None or (dim is not None and dim != spec.dim):
            return (x.mean() if dim is None else x.mean(dim, keepdim=keepdim)), None
        if dim is None:
            return x.sum(), x.numel() * self.axis.size
        return x.sum(dim, keepdim=keepdim), x.shape[dim] * self.axis.size

    def finish_means(self, parts: List[Tuple[torch.Tensor, Optional[int]]]
                     ) -> List[torch.Tensor]:
        """The means of ``partial_mean``'s parts: the partial sums summed over
        the group in one all-reduce, each divided by its count."""
        split = [i for i, (_, count) in enumerate(parts) if count is not None]
        means = [value for value, _ in parts]
        if not split:
            return means
        total = self.psum(torch.cat([means[i].reshape(-1).float() for i in split]))
        for i, piece in zip(split, total.split([means[i].numel() for i in split])):
            means[i] = piece.view_as(means[i]) / parts[i][1]
        return means

    def gather(self, tensors: Mapping[str, torch.Tensor],
               specs: Optional[Mapping[str, Optional[Shard]]] = None) -> Dict[str, torch.Tensor]:
        return gather_state_dict(tensors, self.axis, self.specs if specs is None else specs)

    def local(self, tensors: Mapping[str, torch.Tensor],
              specs: Optional[Mapping[str, Optional[Shard]]] = None) -> Dict[str, torch.Tensor]:
        return shard_state_dict(tensors, self.axis.size, self.axis.index,
                                self.specs if specs is None else specs)

    def global_shape(self, name: str, shape) -> List[int]:
        shape = list(shape)
        spec = self.specs.get(name)
        if spec is not None:
            shape[spec.dim] *= self.axis.size
        return shape


def place_train_state(tp: Optional[TensorParallel], tx, name: str, moment: str
                      ) -> Optional[Shard]:
    """The Shard of one optimizer-state leaf (JAX's ``place_train_state``):
    the parameter's, or, for a factored leaf, ``tx.moment_spec``'s."""
    if tp is None:
        return None
    spec = tp.specs.get(name)
    if spec is None:
        return None
    return tx.moment_spec(moment, name, spec)
