"""PPNet / PosPool (Liu et al. 2020): a position-pooling point backbone.

The port of ``deepviewagg_tpu/nn/ppnet.py`` (the reference's
``modules/PPNet/{ops.py,blocks.py}``): a parameter-free neighbourhood
aggregation, the neighbours' features modulated by a positional prior (the
raw relative xyz, or sinusoidal embeddings of it) and reduced; the learned
capacity lives in the 1x1 dense layers around it.  Neighbour tables come
from :func:`deepviewagg_tpu_torch.nn.pointnet2.build_pointnet_graph`
(``self_k > 0`` for the same-level bottlenecks).  Float32 throughout, batch
norms with momentum 0.98, leaky ReLU 0.2.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import MaskedBatchNorm
from .pointnet2 import decode, fp_decoder, graph_levels

__all__ = ["PosPoolLayer", "PPNetSeg"]

MOMENTUM = 0.98


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _position_prior(rel: torch.Tensor, channels: int,
                    embedding: str) -> torch.Tensor:
    """``[N, M, 3]`` relative positions -> ``[N, M, channels]`` prior (ref
    ops.py:60-101: 'xyz' repeats each coordinate across a third of the
    channels; 'sin_cos' interleaves sin / cos at geometric wavelengths,
    alpha 100, base 1000)."""
    n, m, _ = rel.shape
    if embedding == "xyz":
        if channels % 3:
            raise ValueError("the xyz prior needs channels % 3 == 0")
        return torch.repeat_interleave(rel, channels // 3, dim=-1)
    if embedding == "sin_cos":
        feat_dim = max(channels // 6, 1)
        steps = torch.arange(feat_dim, dtype=rel.dtype, device=rel.device)
        dim_mat = torch.pow(1000.0, steps / feat_dim)
        pos = 100.0 * rel[..., None] / dim_mat          # [N, M, 3, F]
        emb = torch.cat([torch.sin(pos), torch.cos(pos)], -1)
        emb = emb.reshape(n, m, 6 * feat_dim)
        if emb.shape[-1] < channels:                    # channels % 6 != 0
            emb = torch.cat([emb, rel], -1)[..., :channels]
        return emb[..., :channels]
    raise ValueError(embedding)


def _padded_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``concat([x, 0])[min(idx, len(x))]`` (``[N, M, C]``) by
    ``index_select``: an index past the last row reads zeros."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    n, m = idx.shape
    flat = torch.clamp(idx, max=x.shape[0]).reshape(-1)
    return pad.index_select(0, flat).reshape(n, m, x.shape[1])


class PosPoolLayer(nn.Module):
    """One PosPool aggregation (ref ops.py:7-137): ``feats [P, C]`` gathered
    by ``group [N, M]`` (an index ``>= P`` reads zeros), modulated by the
    prior of ``rel / radius``, reduced over the ``count`` first slots
    (``'avg'``, ``'sum'`` or ``'max'``), ``MaskedBatchNorm_0`` + leaky ReLU,
    then, when the width changes, ``Dense_0`` + ``MaskedBatchNorm_1``."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 embedding: str = "xyz", reduction: str = "avg",
                 device=None):
        super().__init__()
        if reduction not in ("avg", "sum", "max"):
            raise ValueError(reduction)
        self.radius, self.embedding = radius, embedding
        self.reduction = reduction
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels, MOMENTUM,
                                                 device=device)
        if out_channels != in_channels:
            self.Dense_0 = nn.Linear(in_channels, out_channels, bias=False,
                                     device=device)
            self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels, MOMENTUM,
                                                     device=device)

    def forward(self, feats, rel, group, count, center_valid):
        n, m = group.shape
        c = feats.shape[-1]
        nbr = _padded_rows(feats, group)                  # [N, M, C]
        agg = nbr * _position_prior(rel / self.radius, c, self.embedding)
        slot = torch.arange(m, device=group.device)[None, :]
        mask = (slot < count[:, None])[..., None]
        if self.reduction == "max":
            x = torch.amax(torch.where(mask, agg, -6.5e4), dim=1)
        else:
            x = torch.sum(torch.where(mask, agg, 0.0), dim=1)
            if self.reduction == "avg":
                x = x / torch.clamp(count[:, None], min=1)
        x = _leaky(self.MaskedBatchNorm_0(x, center_valid))
        if hasattr(self, "Dense_0"):
            x = _leaky(self.MaskedBatchNorm_1(self.Dense_0(x), center_valid))
        return x


class _Bottleneck(nn.Module):
    """PPNet residual bottleneck (ref blocks.py): 1x1 down (``Dense_0``,
    ``MaskedBatchNorm_0``) -> ``pospool`` -> 1x1 up (``Dense_1``,
    ``MaskedBatchNorm_1``) + shortcut (``Dense_2`` when the width
    changes)."""

    def __init__(self, in_channels: int, channels: int, radius: float,
                 embedding: str = "xyz", device=None):
        super().__init__()
        c4 = channels // 4
        self.Dense_0 = nn.Linear(in_channels, c4, bias=False, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(c4, MOMENTUM, device=device)
        self.pospool = PosPoolLayer(c4, c4, radius, embedding, device=device)
        self.Dense_1 = nn.Linear(c4, channels, bias=False, device=device)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(channels, MOMENTUM,
                                                 device=device)
        if in_channels != channels:
            self.Dense_2 = nn.Linear(in_channels, channels, bias=False,
                                     device=device)

    def forward(self, x, rel, group, count, valid):
        h = _leaky(self.MaskedBatchNorm_0(self.Dense_0(x), valid))
        h = self.pospool(h, rel, group, count, valid)
        h = self.MaskedBatchNorm_1(self.Dense_1(h), valid)
        sc = self.Dense_2(x) if hasattr(self, "Dense_2") else x
        return _leaky(sc + h)


class PPNetSeg(nn.Module):
    """Compact PPNet encoder-decoder over a pointnet-style graph (the flax
    names: ``Dense_0`` / ``MaskedBatchNorm_0`` lift the input, ``pool<i>``
    per level and, with ``bottlenecks``, ``block<i>``, then the FP stages
    ``Dense_<1 + j>`` / ``MaskedBatchNorm_<1 + j>``, then ``head``).

    The JAX module adds the same-level bottlenecks when the graph holds
    ``self_group`` tables (built with ``self_k > 0``); here ``bottlenecks``
    says so at construction, and a graph that disagrees raises.  Widths
    divisible by 12 tile the xyz prior at both the stage pools (C) and the
    bottlenecks' inner pools (C / 4)."""

    def __init__(self, num_classes: int, in_channels: int,
                 channels: Sequence[int] = (48, 96, 192),
                 radii: Sequence[float] = (0.15, 0.3, 0.6),
                 embedding: str = "xyz", bottlenecks: bool = False,
                 device="cuda", seed=0):
        super().__init__()
        self.n_levels = n = len(channels)
        self.bottlenecks = bottlenecks
        self.Dense_0 = nn.Linear(in_channels, channels[0], bias=False,
                                 device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(channels[0], MOMENTUM,
                                                 device=device)
        widths = [channels[0]]
        for li, (c, r) in enumerate(zip(channels, radii)):
            setattr(self, f"pool{li}", PosPoolLayer(
                widths[-1], c, r, embedding, device=device))
            if bottlenecks:
                setattr(self, f"block{li}", _Bottleneck(
                    c, c, r * 2, embedding, device=device))
            widths.append(c)
        c = fp_decoder(self, widths[:n], widths[n],
                       [channels[max(li - 1, 0)] for li in range(n)],
                       dense_first=1, norm_first=1, momentum=MOMENTUM,
                       device=device)
        self.head = nn.Linear(c, num_classes, device=device)
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        graph = batch["pn_graph"]
        levels = graph_levels(graph, self.n_levels)
        pos = [p.to(torch.float32) for p in graph["pos"]]
        valid = batch["valid"]
        x = _leaky(self.MaskedBatchNorm_0(self.Dense_0(batch["feats"]),
                                          valid))
        skips = [(x, valid)]
        for li, lvl in enumerate(levels):
            if ("self_group" in lvl) != self.bottlenecks:
                has = "with" if "self_group" in lvl else "without"
                raise ValueError(
                    f"level {li}: PPNetSeg(bottlenecks={self.bottlenecks}) "
                    f"on a graph {has} self_group tables "
                    f"(build_pointnet_graph's self_k)")
            group = lvl["group"]
            rel = _padded_rows(pos[li], group) - pos[li + 1][:, None, :]
            valid = lvl["center_valid"]
            x = getattr(self, f"pool{li}")(x, rel, group, lvl["group_count"],
                                           valid)
            if self.bottlenecks:
                sg = lvl["self_group"]
                srel = _padded_rows(pos[li + 1], sg) - pos[li + 1][:, None, :]
                x = getattr(self, f"block{li}")(x, srel, sg,
                                                lvl["self_count"], valid)
            skips.append((x, valid))
        x = decode(self, x, skips, levels, dense_first=1, norm_first=1,
                   act=_leaky)
        return {"logits": self.head(x)}
