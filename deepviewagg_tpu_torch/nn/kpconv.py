"""KPConv: kernel-point convolution over a pointnet-style graph.

The port of ``deepviewagg_tpu/nn/kpconv.py`` (the reference's KPConv family,
modules/KPConv/: blocks.py, kernels.py, convolution_ops.py over
torch-points-kernels' neighbour ops):

  * kernel point dispositions: the JAX package's deterministic repulsion
    relaxation on the sphere, in numpy, byte-equal to it;
  * neighbours: the host-built ball-query tables of
    :func:`deepviewagg_tpu_torch.nn.pointnet2.build_pointnet_graph`;
  * the conv: linear influences ``max(0, 1 - |y_n - x - k_p| / sigma)``
    summed per kernel point (bf16 operands, rounded to a bf16 result), then
    contracted with the ``[K, Cin, Cout]`` weights (bf16 operands, float32
    accumulation), as the JAX package rounds them: both products run as
    float32 GEMMs of bf16-rounded operands, and autograd rounds their
    cotangents at the same casts.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .norm import MaskedBatchNorm
from .pointnet2 import decode, fp_decoder, graph_levels, grouped_rows

__all__ = ["kernel_point_dispositions", "KPConvLayer", "KPConvSeg"]


@functools.lru_cache(maxsize=8)
def kernel_point_dispositions(num_points: int = 15, radius: float = 1.0,
                              iters: int = 100, seed: int = 0) -> np.ndarray:
    """Deterministic kernel-point layout: one centre point + repulsion-relaxed
    shell points in the ball (kernels.py kernel_point_optimization_debug
    equivalent, without the .ply cache).  Cached: do not write into it."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_points, 3))
    pts[0] = 0.0
    for _ in range(iters):
        diff = pts[:, None] - pts[None]                    # [K, K, 3]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        rep = (diff / d[..., None] / (d[..., None] ** 2 + 1e-3)).sum(axis=1)
        pts[1:] += 0.01 * rep[1:]
        norms = np.linalg.norm(pts[1:], axis=1, keepdims=True)
        pts[1:] = np.where(norms > 1.0, pts[1:] / norms, pts[1:])
        pts[0] = 0.0
    return (pts * radius).astype(np.float32)


def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in float32 (its cotangent is rounded
    to bf16 on the way back)."""
    return t.to(torch.bfloat16).to(torch.float32)


class KPConvLayer(nn.Module):
    """One rigid KPConv: ``out[i] = sum_n sum_k h(|rel_nk|) f_n W_k``;
    ``weight`` is the flax ``kernel [K, Cin, Cout]`` as it is."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_kernel_points: int = 15, radius: float = 0.3,
                 device=None):
        super().__init__()
        self.radius = radius
        self.num_kernel_points = num_kernel_points
        self.weight = nn.Parameter(torch.empty(
            num_kernel_points, in_channels, out_channels, device=device))

    def forward(self, feats, rel_pos, nbr_feat_idx, nbr_count, valid):
        """rel_pos f32 [M, k, 3] (neighbour - centre), nbr_feat_idx int
        [M, k] rows into ``feats``, nbr_count [M]; invalid centres 0."""
        kp = torch.from_numpy(kernel_point_dispositions(
            self.num_kernel_points, self.radius * 0.66)).to(rel_pos.device)
        sigma = self.radius / 2.5
        m, k, _ = rel_pos.shape
        diff = rel_pos[:, :, None, :] - kp[None, None, :, :]
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))     # [M, k, K]
        infl = torch.clamp(1.0 - d / sigma, min=0.0)
        slot = torch.arange(k, device=rel_pos.device)[None, :]
        slot_ok = slot < torch.clamp(nbr_count[:, None], min=1)
        infl = infl * slot_ok[..., None]
        f = _bf16_rounded(grouped_rows(feats, nbr_feat_idx))   # [M, k, Cin]
        # accumulate per kernel point: [M, K, Cin] (a bf16 result)
        fk = _bf16_rounded(torch.bmm(_bf16_rounded(infl).transpose(1, 2), f))
        kk, cin, cout = self.weight.shape
        out = fk.reshape(m, kk * cin) @ _bf16_rounded(self.weight).reshape(
            kk * cin, cout)
        return torch.where(valid[:, None], out, 0.0)


class KPConvSeg(nn.Module):
    """Compact KPConv encoder-decoder over a pointnet-style graph (the flax
    names: ``kp<i>`` + ``MaskedBatchNorm_<i>`` per level, then the FP
    stages ``Dense_<j>`` / ``MaskedBatchNorm_<L + j>``, then ``head``).
    ``forward(batch)`` returns ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 channels: Sequence[int] = (64, 128, 256),
                 radii: Sequence[float] = (0.15, 0.3, 0.6),
                 device="cuda", seed=0):
        super().__init__()
        self.n_levels = n = len(channels)
        widths = [in_channels]
        for li, (c, r) in enumerate(zip(channels, radii)):
            setattr(self, f"kp{li}", KPConvLayer(widths[-1], c, radius=r,
                                                 device=device))
            setattr(self, f"MaskedBatchNorm_{li}", MaskedBatchNorm(
                c, device=device))
            widths.append(c)
        c = fp_decoder(self, widths[:n], widths[n],
                       [channels[max(li - 1, 0)] for li in range(n)],
                       norm_first=n, device=device)
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
            group = lvl["group"]
            rel = grouped_rows(pos[li], group) - pos[li + 1][:, None, :]
            x = getattr(self, f"kp{li}")(x, rel, group, lvl["group_count"],
                                         lvl["center_valid"])
            valid = lvl["center_valid"]
            x = F.relu(getattr(self, f"MaskedBatchNorm_{li}")(x, valid))
            skips.append((x, valid))
        x = decode(self, x, skips, levels, norm_first=self.n_levels)
        return {"logits": self.head(x)}
