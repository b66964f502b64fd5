"""RandLA-Net-style backbone: random sampling + local spatial encoding +
attentive pooling.

The port of ``deepviewagg_tpu/nn/randlanet.py`` (the reference's RandLANet
family, modules/RandLANet/; Hu et al. 2020):

  * aggressive random decimation between levels, chosen on the host in
    :func:`build_randla_graph` (numpy ``Generator.choice``, as the JAX
    package draws it) with kNN tables from :func:`..ops.knn.knn` on CPU
    tensors;
  * LocSE: relative position, distance and absolute position of each
    neighbour, encoded and concatenated to its features;
  * attentive pooling: a learned softmax over the ``k`` neighbours.

Float32 throughout.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import knn as _knn
from .norm import MaskedBatchNorm
from .pointnet2 import _separated, graph_levels, grouped_rows

__all__ = ["build_randla_graph", "RandLANetSeg"]


def build_randla_graph(
    pos: np.ndarray,
    batch_idx: np.ndarray,
    valid: np.ndarray,
    decimation: int = 4,
    num_levels: int = 3,
    k: int = 16,
    seed: int = 0,
) -> Dict:
    """Host-side: random decimation levels + kNN neighbourhoods per level, as
    numpy tables (``batch_to_torch`` moves them)."""
    rng = np.random.default_rng(seed)
    sep = _separated(pos, batch_idx)
    levels = []
    cur_pos, cur_valid = sep, np.asarray(valid, bool)
    all_pos = [sep]
    for _ in range(num_levels):
        n = len(cur_pos)
        m = max(16, n // decimation)
        # random sampling among valid points (RandLA's core trick)
        cand = np.nonzero(cur_valid)[0]
        if len(cand) == 0:
            cand = np.arange(n)
        centers = np.sort(rng.choice(cand, min(m, len(cand)), replace=False))
        pts = torch.from_numpy(np.ascontiguousarray(cur_pos))
        d2, nbr = _knn.knn(pts, pts, k=k, valid=torch.from_numpy(cur_valid))
        up_d2, up_idx = _knn.knn(pts, pts[torch.from_numpy(centers)], k=1)
        levels.append({
            "nbr": nbr.numpy().astype(np.int32),      # kNN at the FINE level
            "nbr_d2": d2.numpy().astype(np.float32),
            "centers": centers.astype(np.int32),
            "center_valid": cur_valid[centers],
            # fine -> nearest centre
            "up_idx": up_idx.numpy().astype(np.int32),
            "up_d2": up_d2.numpy().astype(np.float32),
        })
        cur_pos = cur_pos[centers]
        cur_valid = cur_valid[centers]
        all_pos.append(cur_pos)
    return {"levels": levels, "pos": all_pos}


class _AttentivePool(nn.Module):
    """Softmax-scored neighbour aggregation: ``Dense_0`` scores, ``Dense_1``
    projects the pooled features."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_channels, in_channels, bias=False,
                                 device=device)
        self.Dense_1 = nn.Linear(in_channels, out_channels, bias=False,
                                 device=device)

    def forward(self, feats_nk):
        scores = self.Dense_0(feats_nk)                        # [N, k, C]
        attn = torch.exp(scores - torch.amax(scores, dim=1, keepdim=True))
        attn = attn / torch.clamp(torch.sum(attn, dim=1, keepdim=True),
                                  min=1e-9)
        return self.Dense_1(torch.sum(feats_nk * attn, dim=1))


class RandLANetSeg(nn.Module):
    """RandLA-Net encoder-decoder over :func:`build_randla_graph`'s tables
    (the flax names: per level ``Dense_<i>`` (LocSE), ``_AttentivePool_<i>``
    and ``MaskedBatchNorm_<i>``, then the decoder's ``Dense_<L + j>`` /
    ``MaskedBatchNorm_<L + j>``, then ``head``).  ``forward(batch)`` returns
    ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 channels: Sequence[int] = (32, 64, 128), device="cuda",
                 seed=0):
        super().__init__()
        self.n_levels = n = len(channels)
        width = in_channels
        for li, c in enumerate(channels):
            setattr(self, f"Dense_{li}", nn.Linear(7, c // 2, bias=False,
                                                   device=device))
            setattr(self, f"_AttentivePool_{li}", _AttentivePool(
                c // 2 + width, c, device=device))
            setattr(self, f"MaskedBatchNorm_{li}", MaskedBatchNorm(
                c, device=device))
            width = c
        for j, li in enumerate(reversed(range(n))):
            c = channels[li]
            setattr(self, f"Dense_{n + j}", nn.Linear(width + c, c,
                                                      bias=False,
                                                      device=device))
            setattr(self, f"MaskedBatchNorm_{n + j}", MaskedBatchNorm(
                c, device=device))
            width = c
        self.head = nn.Linear(width, num_classes, device=device)
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        graph = batch["rl_graph"]
        levels = graph_levels(graph, self.n_levels)
        pos = [p.to(torch.float32) for p in graph["pos"]]
        x, valid = batch["feats"], batch["valid"]
        skips = []
        for li, lvl in enumerate(levels):
            nbr, p = lvl["nbr"], pos[li]
            rel = grouped_rows(p, nbr) - p[:, None, :]            # [N, k, 3]
            d = torch.sqrt(torch.clamp(lvl["nbr_d2"], min=0.0))[..., None]
            locse = getattr(self, f"Dense_{li}")(torch.cat(
                [rel, d, p[:, None, :].expand(rel.shape)], dim=-1))
            g = torch.cat([locse, grouped_rows(x, nbr)], dim=-1)
            h = getattr(self, f"_AttentivePool_{li}")(g)
            h = F.relu(getattr(self, f"MaskedBatchNorm_{li}")(h, valid))
            skips.append((h, valid))
            # random decimation
            x = h.index_select(0, lvl["centers"])
            valid = lvl["center_valid"]
        for j, li in enumerate(reversed(range(self.n_levels))):
            h_fine, fine_valid = skips[li]
            up = x.index_select(0, levels[li]["up_idx"][:, 0])
            x = getattr(self, f"Dense_{self.n_levels + j}")(
                torch.cat([up, h_fine], dim=-1))
            x = F.relu(getattr(self, f"MaskedBatchNorm_{self.n_levels + j}")(
                x, fine_valid))
        return {"logits": self.head(x)}
