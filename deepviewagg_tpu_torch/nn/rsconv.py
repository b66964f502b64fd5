"""RSConv: relation-shape convolution over a pointnet-style graph.

The port of ``deepviewagg_tpu/nn/rsconv.py`` (the reference's RSConv family,
modules/RSConv/): the weight of each neighbour is generated from its
low-level spatial relation (distance, relative xyz) by a shared MLP and
gates the neighbour's features; a masked max over the neighbourhood, a
dense layer and a masked batch norm follow.  Float32 throughout:

    h_ij = MLP_rel([d_ij, rel_ij]) * f_j
    out_i = relu(norm(max_j h_ij W))
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import MaskedBatchNorm
from .pointnet2 import decode, fp_decoder, graph_levels, grouped_rows

__all__ = ["RSConvLayer", "RSConvSeg"]


class RSConvLayer(nn.Module):
    """The flax names: ``Dense_1`` (relation -> 16) and ``Dense_0`` (16 ->
    Cin) generate the weights (flax names the outer call's module first),
    ``Dense_2`` and ``MaskedBatchNorm_0`` follow the max."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.Dense_1 = nn.Linear(4, 16, bias=False, device=device)
        self.Dense_0 = nn.Linear(16, in_channels, bias=False, device=device)
        self.Dense_2 = nn.Linear(in_channels, out_channels, bias=False,
                                 device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, rel_pos, nbr_idx, nbr_count, valid):
        m, k, _ = rel_pos.shape
        d = torch.sqrt(torch.sum(rel_pos * rel_pos, dim=-1, keepdim=True))
        relation = torch.cat([d, rel_pos], dim=-1)           # [M, k, 4]
        f = grouped_rows(feats, nbr_idx)                      # [M, k, C]
        w = self.Dense_0(F.relu(self.Dense_1(relation)))
        slot = torch.arange(k, device=rel_pos.device)[None, :]
        slot_ok = slot < torch.clamp(nbr_count[:, None], min=1)
        h = torch.where(slot_ok[..., None], w * f, -1e30)
        agg = torch.where(valid[:, None], torch.amax(h, dim=1), 0.0)
        out = self.MaskedBatchNorm_0(self.Dense_2(agg), valid)
        return F.relu(out)


class RSConvSeg(nn.Module):
    """Compact RSConv encoder-decoder over a pointnet-style graph (the flax
    names: ``rs<i>`` per level, then the FP stages ``Dense_<j>`` /
    ``MaskedBatchNorm_<j>`` at ``max(width, 16)``, then ``head``).
    ``forward(batch)`` returns ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 channels: Sequence[int] = (32, 64, 128), device="cuda",
                 seed=0):
        super().__init__()
        self.n_levels = n = len(channels)
        widths = [in_channels]
        for li, c in enumerate(channels):
            setattr(self, f"rs{li}", RSConvLayer(widths[-1], c,
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
            x = getattr(self, f"rs{li}")(x, rel, lvl["group"],
                                         lvl["group_count"],
                                         lvl["center_valid"])
            valid = lvl["center_valid"]
            skips.append((x, valid))
        return {"logits": self.head(decode(self, x, skips, levels))}
