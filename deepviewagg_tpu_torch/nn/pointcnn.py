"""PointCNN: X-transformed convolution over neighbour sets.

The port of ``deepviewagg_tpu/nn/pointcnn.py`` (the reference's PointCNN
family, modules/PointCNN/; Li et al. 2018): each representative point
learns a ``k x k`` transform X from its neighbours' relative coordinates;
X weights and permutes the lifted neighbour features before a shared dense
layer.  The X-transform product has bf16 operands and a bf16 result, as in
the JAX package (a float32 GEMM of bf16-rounded operands, rounded once
more), the rest is float32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .kpconv import _bf16_rounded
from .norm import MaskedBatchNorm
from .pointnet2 import decode, fp_decoder, graph_levels, grouped_rows

__all__ = ["XConv", "PointCNNSeg"]


class XConv(nn.Module):
    """One X-Conv over neighbourhoods of ``k`` slots (the graph's ``k``):
    ``Dense_0`` / ``Dense_1`` lift the relative coordinates, ``Dense_2`` /
    ``Dense_3`` learn X, ``Dense_4`` and ``MaskedBatchNorm_0`` follow."""

    def __init__(self, in_channels: int, out_channels: int, k: int,
                 lift_channels: int = 16, device=None):
        super().__init__()
        self.k = k
        self.Dense_0 = nn.Linear(3, lift_channels, device=device)
        self.Dense_1 = nn.Linear(lift_channels, lift_channels, device=device)
        self.Dense_2 = nn.Linear(k * 3, k * k, device=device)
        self.Dense_3 = nn.Linear(k * k, k * k, device=device)
        self.Dense_4 = nn.Linear(k * (lift_channels + in_channels),
                                 out_channels, bias=False, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, rel_pos, nbr_idx, nbr_count, valid):
        m, k, _ = rel_pos.shape
        if k != self.k:
            raise ValueError(f"XConv built for {self.k} neighbours, the "
                             f"graph has {k}")
        delta = F.relu(self.Dense_1(F.relu(self.Dense_0(rel_pos))))
        g = torch.cat([delta, grouped_rows(feats, nbr_idx)], dim=-1)
        x_flat = self.Dense_3(F.relu(self.Dense_2(rel_pos.reshape(m, k * 3))))
        x_mat = x_flat.reshape(m, k, k)
        # mask filler slots so that they neither contribute nor receive
        slot = torch.arange(k, device=rel_pos.device)[None, :]
        slot_ok = slot < torch.clamp(nbr_count[:, None], min=1)
        x_mat = x_mat * slot_ok[:, None, :] * slot_ok[:, :, None]
        h = _bf16_rounded(torch.bmm(_bf16_rounded(x_mat), _bf16_rounded(g)))
        out = self.Dense_4(h.reshape(m, k * g.shape[-1]))
        out = self.MaskedBatchNorm_0(out, valid)
        return F.relu(torch.where(valid[:, None], out, 0.0))


class PointCNNSeg(nn.Module):
    """Compact X-Conv encoder-decoder over a pointnet-style graph built with
    ``k`` neighbours (the flax names: ``xconv<i>`` per level, then the FP
    stages ``Dense_<j>`` / ``MaskedBatchNorm_<j>`` at ``max(width, 16)``,
    then ``head``).  ``forward(batch)`` returns ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int, k: int,
                 channels: Sequence[int] = (32, 64, 128), device="cuda",
                 seed=0):
        super().__init__()
        self.n_levels = n = len(channels)
        widths = [in_channels]
        for li, c in enumerate(channels):
            setattr(self, f"xconv{li}", XConv(widths[-1], c, k,
                                              device=device))
            widths.append(c)
        c = fp_decoder(self, widths[:n], widths[n],
                       [max(channels[max(li - 1, 0)], 16) for li in range(n)],
                       device=device)
        self.head = nn.Linear(c, num_classes, device=device)
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        graph = batch["pn_graph"]
        levels = graph_levels(graph, self.n_levels)
        pos = [p.to(torch.float32) for p in graph["pos"]]
        x, valid = batch["feats"], batch["valid"]
        skips = [(x, valid)]
        for li, lvl in enumerate(levels):
            rel = grouped_rows(pos[li], lvl["group"]) - pos[li + 1][:, None, :]
            x = getattr(self, f"xconv{li}")(x, rel, lvl["group"],
                                            lvl["group_count"],
                                            lvl["center_valid"])
            valid = lvl["center_valid"]
            skips.append((x, valid))
        return {"logits": self.head(decode(self, x, skips, levels))}
