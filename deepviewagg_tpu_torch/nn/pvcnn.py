"""PVCNN: point-voxel convolution (dense 3D convs beside a point MLP).

The port of ``deepviewagg_tpu/nn/pvcnn.py`` (the reference's PVCNN family,
modules/PVCNN/, over a CUDA voxelization kernel; Liu et al. 2019).  Each
PVConv block averages the point features per cell of a small dense grid,
runs two 3x3x3 convolutions with group norms on it, devoxelizes trilinearly
back to the points and adds a point-wise dense branch.

  * The voxel mean is a segment sum over the flattened cell keys.  The JAX
    package takes an unsorted ``jax.ops.segment_sum`` (XLA); here each
    block sorts its keys once (stable, on the keys' device) and reduces the
    sorted rows with :func:`deepviewagg_tpu_torch.ops.segment.segment_csr`
    over ``B * r^3 + 1`` segments (the last one the padding rows' drop
    cell): a sum and a count per block, no atomics, the ported kernel
    ``csrc/segment_csr.cu`` on the card (its backward
    ``csrc/segment_csr_bwd.cu`` where the block's input takes a gradient).
  * The convolutions are cuDNN's (the JAX package leaves them to XLA): the
    grid is rounded to bf16 and the float32 kernel applied to it in
    float32, as flax's ``Conv(dtype=None)`` promotes a bf16 input against a
    float32 kernel; TF32 stays off.  ``GroupNorm_<i>`` is flax's (eps 1e-6).
  * The trilinear gather clamps the padding rows' ``batch_idx`` into the
    grid, as a JAX gather clamps an index past the end, and sends their
    cotangent nowhere, as the gather's transpose (an XLA scatter) drops
    it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from .kpconv import _bf16_rounded
from .norm import MaskedBatchNorm

__all__ = ["normalize_to_grid", "PVConv", "PVCNNSeg"]


def normalize_to_grid(pos, batch_idx, valid, resolution: int,
                      num_batches: int):
    """Host-side: per-sample normalized coordinates in ``[0, R-1]``.

    Returns float32 ``[N, 3]`` grid coords (continuous, for the trilinear
    devoxelization) and the flattened voxel key ``[N]`` int32 of the
    containing cell (padding rows: the drop cell ``B * R^3``)."""
    pos = np.asarray(pos, np.float32)
    batch_idx = np.asarray(batch_idx)
    gc = np.zeros_like(pos)
    r = resolution
    for b in range(num_batches):
        sel = (batch_idx == b) & np.asarray(valid)
        if not sel.any():
            continue
        lo = pos[sel].min(axis=0)
        hi = pos[sel].max(axis=0)
        gc[sel] = (pos[sel] - lo) / np.maximum(hi - lo, 1e-6) * (r - 1)
    cell = np.clip(gc.astype(np.int64), 0, r - 1)
    key = ((batch_idx.astype(np.int64) * r + cell[:, 0]) * r
           + cell[:, 1]) * r + cell[:, 2]
    key = np.where(np.asarray(valid), key, num_batches * r**3)
    return gc.astype(np.float32), key.astype(np.int32)


class PVConv(nn.Module):
    """One point-voxel block (the flax names: ``Conv_0``, ``GroupNorm_0``,
    ``Conv_1``, ``GroupNorm_1`` on the voxel branch; ``Dense_0``,
    ``MaskedBatchNorm_0`` on the point branch)."""

    def __init__(self, in_channels: int, out_channels: int,
                 resolution: int = 24, num_batches: int = 1, device=None):
        super().__init__()
        self.resolution, self.num_batches = resolution, num_batches
        groups = min(8, out_channels)
        self.Conv_0 = nn.Conv3d(in_channels, out_channels, 3, padding=1,
                                bias=False, device=device)
        self.GroupNorm_0 = nn.GroupNorm(groups, out_channels, eps=1e-6,
                                        device=device)
        self.Conv_1 = nn.Conv3d(out_channels, out_channels, 3, padding=1,
                                bias=False, device=device)
        self.GroupNorm_1 = nn.GroupNorm(groups, out_channels, eps=1e-6,
                                        device=device)
        self.Dense_0 = nn.Linear(in_channels, out_channels, bias=False,
                                 device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def voxelize(self, feats, voxel_key, valid) -> torch.Tensor:
        """The mean point feature per cell, ``[B, C, r, r, r]`` (0 in an
        empty cell): a segment sum and a segment count over the sorted
        keys."""
        r, b = self.resolution, self.num_batches
        cells = b * r**3
        keys, order = torch.sort(voxel_key, stable=True)
        ptr = seg.segment_ptr(keys, cells + 1)
        ones = valid.to(torch.float32)
        dense_sum = seg.segment_csr(
            (feats * ones[:, None]).index_select(0, order), ptr, None,
            "sum")[:cells]
        dense_cnt = seg.segment_csr(ones.index_select(0, order)[:, None],
                                    ptr, None, "sum")[:cells]
        grid = dense_sum / torch.clamp(dense_cnt, min=1.0)
        return grid.reshape(b, r, r, r, -1).permute(0, 4, 1, 2, 3)

    def devoxelize(self, h, grid_coords, batch_idx) -> torch.Tensor:
        """Trilinear interpolation of ``h [B, C, r, r, r]`` at the points'
        continuous grid coordinates, the eight corners clamped into the
        grid."""
        r, b = self.resolution, self.num_batches
        rows = h.permute(0, 2, 3, 4, 1).reshape(b * r**3, -1)
        f0 = torch.floor(grid_coords).to(torch.int32)
        t = grid_coords - f0
        # a JAX gather clamps an index past the grid (the padding rows'
        # batch_idx == B) and its transpose, an XLA scatter, drops it: such
        # rows read the clamped cells and send them no gradient
        inside = ((batch_idx >= 0) & (batch_idx < b))[:, None]
        bi = torch.clamp(batch_idx, 0, b - 1).to(torch.int64)
        out = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cx = torch.clamp(f0[:, 0] + dx, 0, r - 1)
                    cy = torch.clamp(f0[:, 1] + dy, 0, r - 1)
                    cz = torch.clamp(f0[:, 2] + dz, 0, r - 1)
                    w = ((t[:, 0] if dx else 1 - t[:, 0])
                         * (t[:, 1] if dy else 1 - t[:, 1])
                         * (t[:, 2] if dz else 1 - t[:, 2]))
                    cell = ((bi * r + cx) * r + cy) * r + cz
                    val = rows.index_select(0, cell)
                    val = torch.where(inside, val, val.detach())
                    out = out + val * w[:, None]
        return out

    def forward(self, feats, grid_coords, voxel_key, batch_idx, valid):
        grid = self.voxelize(feats, voxel_key, valid)
        h = F.relu(self.GroupNorm_0(self.Conv_0(_bf16_rounded(grid))))
        h = F.relu(self.GroupNorm_1(self.Conv_1(_bf16_rounded(h))))
        out = self.devoxelize(h, grid_coords, batch_idx)
        p = self.MaskedBatchNorm_0(self.Dense_0(feats), valid)
        return F.relu(out + p)


class PVCNNSeg(nn.Module):
    """PVConv blocks at ``resolutions``, their outputs concatenated ->
    ``Dense_0`` / ``MaskedBatchNorm_0`` -> ``head`` (blocks ``PVConv_<i>``).
    The batch carries ``pv_grid_coords`` at ``pv_resolution``,
    ``pv_batch_idx`` and ``pv_key_r<r>`` per resolution
    (:func:`normalize_to_grid`); ``forward(batch)`` returns ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 channels: Sequence[int] = (32, 64, 128),
                 resolutions: Sequence[int] = (24, 16, 12),
                 num_batches: int = 1, device="cuda", seed=0):
        super().__init__()
        # one block per (width, resolution) pair, as the JAX module zips them
        n = min(len(channels), len(resolutions))
        self.resolutions = tuple(resolutions[:n])
        width = in_channels
        for i, (c, r) in enumerate(zip(channels, self.resolutions)):
            setattr(self, f"PVConv_{i}", PVConv(width, c, r, num_batches,
                                                device=device))
            width = c
        self.Dense_0 = nn.Linear(sum(channels[:n]), channels[-1], bias=False,
                                 device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(channels[-1], device=device)
        self.head = nn.Linear(channels[-1], num_classes, device=device)
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        valid = batch["valid"]
        gc = batch["pv_grid_coords"]
        batch_idx = batch["pv_batch_idx"]
        x = batch["feats"]
        skips = []
        for i, r in enumerate(self.resolutions):
            x = getattr(self, f"PVConv_{i}")(
                x, gc * (r - 1) / (batch["pv_resolution"] - 1),
                batch[f"pv_key_r{r}"], batch_idx, valid)
            skips.append(x)
        x = self.Dense_0(torch.cat(skips, dim=-1))
        x = F.relu(self.MaskedBatchNorm_0(x, valid))
        return {"logits": self.head(x)}
