"""Validity-masked batch normalization, eval path.

The port of ``deepviewagg_tpu/nn/norm.py::MaskedBatchNorm``: the reference
normalizes sparse-voxel features with BatchNorm over active voxels; in eval
mode the layer applies its running statistics (``running_mean`` /
``running_var`` buffers, the flax ``batch_stats`` ``mean`` / ``var``) with
eps 1e-5 in float32.  The masked training statistics wait for the training
slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["MaskedBatchNorm"]


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the row axis of ``x [N, C]``; eval mode only."""

    def __init__(self, channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, valid=None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm training statistics are not ported yet")
        y = (x.to(torch.float32) - self.running_mean) * torch.rsqrt(
            self.running_var + self.epsilon)
        return y * self.weight + self.bias
