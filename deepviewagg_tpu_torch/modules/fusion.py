"""Bimodal fusion: merging pooled 2D features into the 3D stream.

The port of ``deepviewagg_tpu/modules/fusion.py`` (the reference's
``BimodalFusion``, modules/multimodal/fusion.py:7-53): 'residual' adds,
'concatenation' concats, 'both' does residual then concat, 'modality'
replaces; a bias-free linear ``proj`` adapts widths for the residual modes.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BimodalFusion"]


class BimodalFusion(nn.Module):
    def __init__(self, mode: str, channels_3d: int, channels_mod: int,
                 device=None):
        super().__init__()
        if mode not in ("residual", "concatenation", "concat", "both",
                        "modality"):
            raise ValueError(mode)
        self.mode = mode
        self.proj = None
        if mode in ("residual", "both") and channels_mod != channels_3d:
            self.proj = nn.Linear(channels_mod, channels_3d, bias=False,
                                  device=device)
        self.out_channels = {
            "residual": channels_3d, "concatenation": channels_3d + channels_mod,
            "concat": channels_3d + channels_mod, "both": 2 * channels_3d,
            "modality": channels_mod,
        }[mode]

    def forward(self, x_3d, x_mod):
        if self.mode == "modality":
            return x_mod
        if self.mode in ("concatenation", "concat"):
            return torch.cat([x_3d, x_mod], dim=-1)
        res = x_mod if self.proj is None else self.proj(x_mod)
        if self.mode == "residual":
            return x_3d + res
        # reference order: cat((main, main + mod)) (fusion.py:30)
        return torch.cat([x_3d, x_3d + res], dim=-1)
