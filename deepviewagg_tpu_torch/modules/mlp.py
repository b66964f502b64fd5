"""MLP with masked BatchNorm — the reference's ``MLP`` Seq building block
(core/common_modules/base_modules.py:39-49: Linear -> BatchNorm ->
LeakyReLU(0.2) per layer); the port of ``deepviewagg_tpu/modules/mlp.py``.
Linear layers carry a bias only without norm."""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..nn.norm import MaskedBatchNorm

__all__ = ["MLP"]


class MLP(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 norm: bool = True, final_activation: bool = True,
                 negative_slope: float = 0.2, device=None):
        super().__init__()
        self.norm = norm
        self.final_activation = final_activation
        self.negative_slope = negative_slope
        self.num_layers = len(channels)
        c_in = in_channels
        for i, c in enumerate(channels):
            setattr(self, f"Dense_{i}",
                    nn.Linear(c_in, c, bias=not norm, device=device))
            if norm:
                setattr(self, f"MaskedBatchNorm_{i}",
                        MaskedBatchNorm(c, device=device))
            c_in = c
        self.out_channels = c_in

    def forward(self, x, valid=None):
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm:
                x = getattr(self, f"MaskedBatchNorm_{i}")(x, valid)
            if i < self.num_layers - 1 or self.final_activation:
                x = F.leaky_relu(x, negative_slope=self.negative_slope)
        return x
