"""Shape classification: encoder + global pool + classifier head.

The port of ``deepviewagg_tpu/models/classification.py`` (the reference's
classification task stack, datasets/classification ModelNet +
models/classification): the Res16UNet encoder, a per-sample masked global
mean and max pool (``ops/sparse_conv.sparse_global_pool``, three launches
of the sorted-segment kernel forward and two of its backward per train
step) and an MLP classifier.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.branch import soft_dropout
from ..nn.res16unet import RES16_PRESETS, DownStage, Stem
from ..ops.sparse_conv import sparse_global_pool

__all__ = ["SparseConv3dCls"]

DROPOUT = 0.3


class SparseConv3dCls(nn.Module):
    """Res16UNet encoder + global mean / max pool + classifier (the flax
    names: ``stem``, ``down<i>``, ``Dense_0``, ``head``).

    ``forward(batch, generator=None)`` returns ``{"logits" [num_batches,
    num_classes]}``.  The Dropout(0.3) before the head is drawn from
    ``generator`` in training mode only, and only when one is given, as
    flax's ``has_rng("dropout")`` gates it."""

    def __init__(self, num_classes: int, backbone: str = "Res16UNet14",
                 num_batches: int = 1, in_channels: int = 4,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        layers, planes, block = RES16_PRESETS[backbone]
        self.num_batches = num_batches
        self.n_down = len(layers) // 2
        self.stem = Stem(in_channels, device=device)
        c = 32
        for i in range(self.n_down):
            setattr(self, f"down{i}", DownStage(c, planes[i], layers[i],
                                                block, device=device))
            c = planes[i]
        self.Dense_0 = nn.Linear(2 * c, 128, device=device)
        self.head = nn.Linear(128, num_classes, device=device)
        if seed is not None:
            from .segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        graph = batch["graph"]
        x = self.stem(batch["feats"], graph)
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x, graph, i)
        lvl = graph["levels"][self.n_down]
        pooled = [sparse_global_pool(x, lvl["batch_idx"], self.num_batches + 1,
                                     valid=lvl["valid"], reduce=r)
                  [: self.num_batches] for r in ("mean", "max")]
        h = F.relu(self.Dense_0(torch.cat(pooled, dim=-1)))
        if self.training:
            h = soft_dropout(h, DROPOUT, generator)
        return {"logits": self.head(h)}
