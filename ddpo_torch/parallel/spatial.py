"""Whole-UNet spatial sharding: the latent's H split over the sp axis.

Port of ddpo_tpu/parallel/spatial.py. JAX runs the entire UNet forward in
one shard_map with H sharded over sp; here each rank of an sp group runs
the UNet, built with ``set_spatial(axis)`` (JAX's ``clone(spatial_axis=)``),
on its own rows, and the modules exchange what they need over the group
(ops/spatial.py):

  - 3x3 convs take one boundary row from each H neighbour;
  - stride-2 downsamples take only the previous shard's last row;
  - GroupNorm all-reduces its per-(batch, group) moment sums;
  - self-attention all-gathers K/V (exact softmax on local queries);
    cross-attention's 77-token context is whole on every rank;
  - the nearest 2x upsample is shard-local.

Per UNet forward at SD-1.4: 49 halo exchanges, 3 top halos, 61 moment
all-reduces, 16 K/V gathers and the output gather. Every collective has an
exact transpose, so the same sharded forward serves PPO training; each
rank's parameter gradients are then its rows' part, and the gradient reduce
sums them over sp (and averages over dp).

The applies take the full latents, which every rank of the group holds (as
JAX's sampler runs at the GSPMD level on full latents), take this rank's
rows, and all-gather eps along H; that gather's backward takes this rank's
slice of the cotangent, since every rank computes the same loss from the
gathered eps.
"""

from __future__ import annotations

from typing import Callable

import torch

from ddpo_torch.ops.spatial import gather_rows, shard_rows, validate_spatial_geometry


def levels_of(unet) -> int:
    """Stride-2 downsamples of the UNet (3 for SD-1.4)."""
    return len(unet.config.block_out_channels) - 1


def spatial_apply(fn: Callable, axis, levels: int) -> Callable:
    """fn(x_rows, t, context) on this rank's rows -> apply(sample, t,
    context) on the full latents (B, C, H, W), eps whole on every rank."""

    def apply(sample: torch.Tensor, t, context) -> torch.Tensor:
        validate_spatial_geometry(sample.shape[2], axis.name, axis.size, levels=levels)
        out = fn(shard_rows(sample, axis, 2, "shard_in"), t, context)
        return gather_rows(out, axis, 2, "gather_out")

    return apply


def make_spatial_unet_apply(mesh, unet, axis: str = "sp") -> Callable:
    """unet_apply(sample, t, context) with H sharded over ``axis``.

    ``unet`` is set to run sharded (``set_spatial``), which changes only its
    compute path: the state dict is the same, so checkpoints, the SD-1.4
    manifest, LoRA and the exports are unaffected.
    """
    ax = mesh.axis(axis)
    unet.set_spatial(ax)
    return spatial_apply(unet, ax, levels_of(unet))
