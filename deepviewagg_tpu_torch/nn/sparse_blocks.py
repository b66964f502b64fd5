"""Sparse-voxel conv blocks.

The port of ``deepviewagg_tpu/nn/sparse_blocks.py`` (``SparseConv``,
``SparseConvNormRelu``, ``ResBlock``, ``BottleneckBlock``,
``SqueezeExcite``, ``SEResBlock``, ``SEBottleneckBlock``; the reference's
modules/SparseConv3d/modules.py:10-220 and the MinkowskiEngine blocks of
modules/MinkowskiEngine/modules.py).  Sub-modules carry the flax
auto-names (``SparseConv_0``, ``MaskedBatchNorm_0``, ``Dense_0`` ...) so
:mod:`deepviewagg_tpu_torch.utils.from_jax` maps parameters by name.

All blocks take ``(feats [cap, C], nbr int32 [K, cap_out], valid bool,
batch_idx)`` and return ``[cap_out, C']``; neighbor tables come from the
host-side graph builder, never computed on device.  ``batch_idx int32
[cap]`` is the level's sorted sample index (padding rows carry the slot
after the last sample); only the squeeze-excitation blocks read it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from ..ops.sparse_conv import (sparse_conv, sparse_conv_pair,
                               sparse_conv_submanifold)
from .norm import MaskedBatchNorm

__all__ = ["SparseConv", "SparseConvNormRelu", "ResBlock", "BottleneckBlock",
           "SqueezeExcite", "SEResBlock", "SEBottleneckBlock"]


class SparseConv(nn.Module):
    """Bare sparse convolution: ``weight [K, Cin, Cout]`` (JAX layout),
    bias-free (no block of the flagship uses one).

    ``submanifold=True`` (same in/out coords, centered odd kernel) and a
    given transpose map ``nbr_t`` (strided pairs) select the convolutions
    with the gather-only backward; anything else is the plain one."""

    def __init__(self, kernel_volume: int, in_channels: int, out_channels: int,
                 submanifold: bool = False, device=None):
        super().__init__()
        self.submanifold = submanifold
        self.weight = nn.Parameter(torch.empty(
            kernel_volume, in_channels, out_channels, device=device))

    def forward(self, feats, nbr, nbr_t=None):
        if self.submanifold and feats.shape[0] == nbr.shape[1]:
            return sparse_conv_submanifold(feats, self.weight, nbr)
        if nbr_t is not None:
            return sparse_conv_pair(feats, self.weight, nbr, nbr_t)
        return sparse_conv(feats, self.weight, nbr)


class SparseConvNormRelu(nn.Module):
    """Conv -> masked BN -> ReLU, the reference's conv/norm/act triplet."""

    def __init__(self, kernel_volume: int, in_channels: int, out_channels: int,
                 relu: bool = True, submanifold: bool = False, device=None):
        super().__init__()
        self.relu = relu
        self.SparseConv_0 = SparseConv(kernel_volume, in_channels,
                                       out_channels, submanifold=submanifold,
                                       device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, nbr, valid, nbr_t=None):
        x = self.MaskedBatchNorm_0(self.SparseConv_0(feats, nbr, nbr_t), valid)
        return F.relu(x) if self.relu else x


def _skip(block: nn.Module, in_channels: int, out_channels: int, k: int,
          device) -> None:
    """The residual path of a block: the identity, or a bias-free linear + BN
    projection when the channel counts differ, registered as ``Dense_<k>`` /
    ``MaskedBatchNorm_<k>`` (the flax names)."""
    if in_channels != out_channels:
        setattr(block, f"Dense_{k}", nn.Linear(in_channels, out_channels,
                                               bias=False, device=device))
        setattr(block, f"MaskedBatchNorm_{k}", MaskedBatchNorm(
            out_channels, device=device))
    block.skip_k = k if in_channels != out_channels else None


def _skip_path(block: nn.Module, feats, valid):
    k = block.skip_k
    if k is None:
        return feats
    return getattr(block, f"MaskedBatchNorm_{k}")(
        getattr(block, f"Dense_{k}")(feats), valid)


class ResBlock(nn.Module):
    """Basic residual block (conv-bn-relu-conv-bn + skip), submanifold, with
    a bias-free linear + BN skip when the channel counts differ."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, device=None):
        super().__init__()
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            kernel_volume, in_channels, out_channels, submanifold=True,
            device=device)
        self.SparseConvNormRelu_1 = SparseConvNormRelu(
            kernel_volume, out_channels, out_channels, relu=False,
            submanifold=True, device=device)
        _skip(self, in_channels, out_channels, 0, device)

    def forward(self, feats, nbr, valid, batch_idx=None):
        x = self.SparseConvNormRelu_0(feats, nbr, valid)
        x = self.SparseConvNormRelu_1(x, nbr, valid)
        return F.relu(x + _skip_path(self, feats, valid))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (the Res16UNet50 / 101 block,
    MinkowskiEngine res16unet.py ``Bottleneck``): bias-free linear + BN +
    relu to ``out // reduction`` channels, a submanifold conv + BN + relu,
    a linear + BN back to ``out``, then the skip add and relu."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, reduction: int = 4, device=None):
        super().__init__()
        mid = out_channels // reduction
        self.Dense_0 = nn.Linear(in_channels, mid, bias=False, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(mid, device=device)
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            kernel_volume, mid, mid, submanifold=True, device=device)
        self.Dense_1 = nn.Linear(mid, out_channels, bias=False, device=device)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels, device=device)
        _skip(self, in_channels, out_channels, 2, device)

    def _residual(self, feats, nbr, valid):
        x = F.relu(self.MaskedBatchNorm_0(self.Dense_0(feats), valid))
        x = self.SparseConvNormRelu_0(x, nbr, valid)
        return self.MaskedBatchNorm_1(self.Dense_1(x), valid)

    def forward(self, feats, nbr, valid, batch_idx=None):
        x = self._residual(feats, nbr, valid)
        return F.relu(x + _skip_path(self, feats, valid))


class SqueezeExcite(nn.Module):
    """Per-sample channel gating (``SELayer``, MinkowskiEngine
    modules.py:276): the mean of each sample's valid rows (a sorted-segment
    mean over ``batch_idx`` with ``max_batches + 1`` segments, the last
    taking the padding), Dense -> relu -> Dense -> sigmoid, and each row
    scaled by its sample's gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 max_batches: int = 32, device=None):
        super().__init__()
        self.max_batches = max_batches
        hidden = max(channels // reduction, 1)
        self.Dense_0 = nn.Linear(channels, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, channels, device=device)

    def forward(self, x, batch_idx, valid):
        pooled = seg.segment_mean(x, batch_idx, self.max_batches + 1,
                                  valid=valid)                # [B + 1, C]
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(pooled))))
        return x * y[torch.clamp(batch_idx, 0, self.max_batches).long()]


class SEResBlock(ResBlock):
    """``ResBlock`` with squeeze-excitation on the residual branch before the
    skip add (``SEBasicBlock``, MinkowskiEngine modules.py:295-321)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, se_reduction: int = 16,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_volume,
                         device=device)
        self.SqueezeExcite_0 = SqueezeExcite(out_channels, se_reduction,
                                             device=device)

    def forward(self, feats, nbr, valid, batch_idx=None):
        if batch_idx is None:
            raise ValueError("SE blocks need the graph's batch_idx")
        x = self.SparseConvNormRelu_0(feats, nbr, valid)
        x = self.SparseConvNormRelu_1(x, nbr, valid)
        x = self.SqueezeExcite_0(x, batch_idx, valid)
        return F.relu(x + _skip_path(self, feats, valid))


class SEBottleneckBlock(BottleneckBlock):
    """Bottleneck + squeeze-excitation (``SEBottleneck``, MinkowskiEngine
    modules.py:336)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, reduction: int = 4,
                 se_reduction: int = 16, device=None):
        super().__init__(in_channels, out_channels, kernel_volume, reduction,
                         device=device)
        self.SqueezeExcite_0 = SqueezeExcite(out_channels, se_reduction,
                                             device=device)

    def forward(self, feats, nbr, valid, batch_idx=None):
        if batch_idx is None:
            raise ValueError("SE blocks need the graph's batch_idx")
        x = self.SqueezeExcite_0(self._residual(feats, nbr, valid), batch_idx,
                                 valid)
        return F.relu(x + _skip_path(self, feats, valid))
