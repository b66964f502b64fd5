"""View pooling: the learned multi-view aggregation of DeepViewAgg.

The port of ``SegmentPool`` (the reference's parameter-free
``BimodalCSRPool``, modules/multimodal/pooling.py:14) and of the group
attention pool of ``deepviewagg_tpu/modules/pooling.py`` (the reference's
``GroupBimodalCSRPool`` with ``DeepSetFeat`` and ``Gating``,
modules/multimodal/pooling.py:159-319,604-716): set-encoded
map features -> per-group compatibilities -> segment softmax -> weighted
segment sum of the value projection -> gating on per-segment max
compatibilities.  All modules take ``(x [E, C], segment_ids [E] sorted,
valid [E], num_segments)`` and return per-segment outputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from .mlp import MLP

__all__ = ["SegmentPool", "Gating", "DeepSetFeat", "GroupViewPool",
           "expand_group_feat", "group_sizes", "nearest_power_of_2"]


def nearest_power_of_2(x, min_power: int = 16) -> int:
    """Reference helper (pooling.py:718-735): nearest power of two with a
    floor."""
    x = int(x)
    if x < min_power:
        return min_power
    prev_p = 2 ** ((x - 1).bit_length() - 1)
    next_p = 2 ** (x - 1).bit_length()
    return prev_p if x - prev_p < next_p - x else next_p


def group_sizes(num_channels: int, num_groups: int):
    """Distribute ``num_channels`` across ``num_groups`` as evenly as
    possible, first groups taking the remainder (pooling.py:738-745)."""
    base = num_channels // num_groups
    rem = num_channels - base * num_groups
    return [base + (1 if i < rem else 0) for i in range(num_groups)]


def expand_group_feat(x, num_groups: int, num_channels: int):
    """Broadcast per-group scalars ``[E, G]`` to channels ``[E, C]``
    (pooling.py:748-756)."""
    if num_groups == 1:
        return x if x.ndim == 1 else x[:, 0:1]
    sizes = torch.as_tensor(group_sizes(num_channels, num_groups),
                            device=x.device)
    return torch.repeat_interleave(x, sizes, dim=-1,
                                   output_size=num_channels)


class SegmentPool(nn.Module):
    """Parameter-free segment reduction (``BimodalCSRPool``, pooling.py:14):
    max / mean / min / sum of the valid elements of each segment."""

    def __init__(self, reduce: str = "max"):
        super().__init__()
        self.reduce = reduce

    def forward(self, x, segment_ids, valid, num_segments: int, ptr=None):
        return seg.segment_reduce(x, segment_ids, num_segments, self.reduce,
                                  valid, ptr)


class Gating(nn.Module):
    """``tanh(relu(w * x + b))`` per group (pooling.py:690-716)."""

    def __init__(self, num_groups: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_groups, device=device))
        self.bias = (nn.Parameter(torch.zeros(num_groups, device=device))
                     if bias else None)

    def forward(self, x):
        out = x * self.weight
        if self.bias is not None:
            out = out + self.bias
        return torch.tanh(F.relu(out))


class DeepSetFeat(nn.Module):
    """Set-aware per-element embedding (reference ``DeepSetFeat``,
    pooling.py:604-674): element MLP -> per-segment pools (+ the
    ``sqrt(1/(n + 1e-3))`` size feature) -> segment MLP -> gather back ->
    fuse -> element MLP."""

    def __init__(self, in_channels: int, out_channels: int,
                 pool_modes: Sequence[str] = ("max",),
                 fusion: str = "concatenation", use_num: bool = True,
                 device=None):
        super().__init__()
        d = out_channels
        self.pool_modes = tuple(pool_modes)
        self.fusion = fusion
        self.use_num = use_num
        self.mlp_elt_1 = MLP(in_channels, [d, d], device=device)
        set_in = d * len(self.pool_modes) + int(use_num)
        self.mlp_set = MLP(set_in, [d, d], device=device)
        fused = d if fusion == "residual" else 2 * d
        self.mlp_elt_2 = MLP(fused, [d, d], device=device)

    def forward(self, x, segment_ids, valid, num_segments: int, ptr=None,
                seg_valid=None, count=None):
        """``count``: the per-segment number of valid elements, when the
        caller already has it (computed here otherwise)."""
        x = self.mlp_elt_1(x, valid)
        x_set = torch.cat([
            seg.segment_reduce(x, segment_ids, num_segments, m, valid, ptr)
            for m in self.pool_modes
        ], dim=-1)
        if self.use_num:
            n = count
            if n is None:
                n = seg.segment_count(segment_ids, num_segments, valid, ptr)
            x_set = torch.cat([x_set, torch.sqrt(1.0 / (n + 1e-3))[:, None]],
                              dim=-1)
        x_set = self.mlp_set(x_set, seg_valid)[segment_ids]
        if self.fusion == "residual":
            fused = x + x_set
        elif self.fusion == "both":
            fused = torch.cat([x, x + x_set], dim=-1)
        else:
            fused = torch.cat([x, x_set], dim=-1)
        return self.mlp_elt_2(fused, valid)


class GroupViewPool(nn.Module):
    """The paper's attention pooling (``GroupBimodalCSRPool``,
    pooling.py:159-319).  Returns ``(pooled [S, C], attention [E, G])``."""

    def __init__(self, in_channels: int, out_channels: int,
                 map_channels: int = 8, num_groups: int = 1,
                 set_channels: int = 32, use_mod: bool = False,
                 gated: bool = True, scaling: bool = True,
                 use_num: bool = True, enc_pool: Sequence[str] = ("max",),
                 enc_fusion: str = "concatenation", device=None):
        super().__init__()
        self.num_groups = num_groups
        self.out_channels = out_channels
        self.use_mod = use_mod
        self.gated = gated
        self.scaling = scaling
        self.set_enc = DeepSetFeat(map_channels, set_channels, enc_pool,
                                   enc_fusion, use_num, device=device)
        # values: 2-layer bias-free MLP, the reference E_mod (pooling.py:245)
        self.e_mod = MLP(in_channels, [out_channels, out_channels],
                         device=device)
        score_in = set_channels
        if use_mod:
            # ref E_mix (pooling.py:250-254)
            mid = nearest_power_of_2(
                (set_channels + out_channels + set_channels) / 2,
                set_channels * 2)
            self.e_mix = MLP(set_channels + out_channels,
                             [mid, set_channels], device=device)
        self.e_score = nn.Linear(score_in, num_groups, device=device)
        if gated:
            self.gating = Gating(num_groups, device=device)

    def forward(self, x_mod, x_map, segment_ids, valid, num_segments: int,
                ptr=None, seg_valid=None, count=None):
        """``count``: the per-segment number of valid elements, when the
        caller already has it.  Each distinct reduction is taken once: the
        count serves the set encoder's size feature and the softmax's
        scaling, the compatibilities' maximum the softmax's shift (detached)
        and the gating (with its gradient)."""
        g, c = self.num_groups, self.out_channels
        if count is None and (self.set_enc.use_num or self.scaling):
            count = seg.segment_count(segment_ids, num_segments, valid, ptr)
        enc = self.set_enc(x_map, segment_ids, valid, num_segments, ptr=ptr,
                           seg_valid=seg_valid, count=count)
        values = self.e_mod(x_mod, valid)
        if self.use_mod:
            enc = self.e_mix(torch.cat([enc, values], dim=-1), valid)
        compat = self.e_score(enc)                                # [E, G]
        cmax = None
        if self.gated:
            cmax = seg.segment_max(compat, segment_ids, num_segments, valid,
                                   ptr)
        attn = seg.segment_softmax(
            compat, segment_ids, num_segments, valid=valid,
            scaling=self.scaling, ptr=ptr, count=count,
            seg_max=None if cmax is None else cmax.detach())
        pooled = seg.segment_weighted_sum(
            values, expand_group_feat(attn, g, c), segment_ids, num_segments,
            valid, ptr)
        if self.gated:
            pooled = pooled * expand_group_feat(self.gating(cmax), g, c)
        return pooled, attn
