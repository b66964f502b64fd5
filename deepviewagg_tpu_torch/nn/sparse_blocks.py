"""Sparse-voxel conv blocks, eval path.

The port of ``deepviewagg_tpu/nn/sparse_blocks.py`` (``SparseConv``,
``SparseConvNormRelu``, ``ResBlock``; the reference's
modules/SparseConv3d/modules.py:10-220).  Sub-modules carry the flax
auto-names (``SparseConv_0``, ``MaskedBatchNorm_0``, ``Dense_0`` ...) so
:mod:`deepviewagg_tpu_torch.utils.from_jax` maps parameters by name.

All blocks take ``(feats [cap, C], nbr int32 [K, cap_out], valid bool)`` and
return ``[cap_out, C']``; neighbor tables come from the host-side graph
builder, never computed on device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import sparse_conv
from .norm import MaskedBatchNorm

__all__ = ["SparseConv", "SparseConvNormRelu", "ResBlock"]


class SparseConv(nn.Module):
    """Bare sparse convolution: ``weight [K, Cin, Cout]`` (JAX layout),
    bias-free (no block of the flagship uses one)."""

    def __init__(self, kernel_volume: int, in_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            kernel_volume, in_channels, out_channels, device=device))

    def forward(self, feats, nbr):
        return sparse_conv(feats, self.weight, nbr)


class SparseConvNormRelu(nn.Module):
    """Conv -> masked BN -> ReLU, the reference's conv/norm/act triplet."""

    def __init__(self, kernel_volume: int, in_channels: int, out_channels: int,
                 relu: bool = True, device=None):
        super().__init__()
        self.relu = relu
        self.SparseConv_0 = SparseConv(kernel_volume, in_channels,
                                       out_channels, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, nbr, valid):
        x = self.MaskedBatchNorm_0(self.SparseConv_0(feats, nbr), valid)
        return F.relu(x) if self.relu else x


class ResBlock(nn.Module):
    """Basic residual block (conv-bn-relu-conv-bn + skip), submanifold, with
    a bias-free linear + BN skip when the channel counts differ."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, device=None):
        super().__init__()
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            kernel_volume, in_channels, out_channels, device=device)
        self.SparseConvNormRelu_1 = SparseConvNormRelu(
            kernel_volume, out_channels, out_channels, relu=False,
            device=device)
        if in_channels != out_channels:
            self.Dense_0 = nn.Linear(in_channels, out_channels, bias=False,
                                     device=device)
            self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels,
                                                     device=device)
        else:
            self.Dense_0 = None

    def forward(self, feats, nbr, valid):
        x = self.SparseConvNormRelu_0(feats, nbr, valid)
        x = self.SparseConvNormRelu_1(x, nbr, valid)
        if self.Dense_0 is not None:
            skip = self.MaskedBatchNorm_0(self.Dense_0(feats), valid)
        else:
            skip = feats
        return F.relu(x + skip)
