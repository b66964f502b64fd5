"""View pooling: the learned multi-view aggregation of DeepViewAgg.

The port of ``deepviewagg_tpu/modules/pooling.py`` (the reference's
modules/multimodal/pooling.py): each reference pool class maps to a module
here,

  ``BimodalCSRPool``            -> :class:`SegmentPool` (max/mean/min/sum)
  ``HeuristicBimodalCSRPool``   -> :class:`HeuristicPool` (arg-extremum of a
                                   named viewing-condition feature)
  ``GroupBimodalCSRPool``       -> :class:`GroupViewPool` (the paper's
                                   attention: set-encoded map features ->
                                   per-group compatibilities -> segment
                                   softmax -> weighted sum -> gating)
  ``QKVBimodalCSRPool``         -> :class:`QKVViewPool`
  ``DeepSetFeat`` / ``MLPSetFeat`` / ``MinMaxDiffSetFeat`` -> set encoders
  ``Gating`` (tanh o relu)      -> :class:`Gating`

All modules take ``(x [E, C], segment_ids [E] sorted, valid [E],
num_segments)`` and return per-segment outputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from .mlp import MLP

__all__ = ["SegmentPool", "HeuristicPool", "Gating", "DeepSetFeat",
           "MinMaxDiffSetFeat", "GroupViewPool", "QKVViewPool",
           "expand_group_feat", "group_sizes", "nearest_power_of_2",
           "VIEW_FEATURE_INDEX"]

# fixed viewing-condition feature order (SURVEY.md §A.3; reference
# HeuristicBimodalCSRPool._FEATURES pooling.py:98-106)
VIEW_FEATURE_INDEX = {
    "normalized_depth": 0,
    "linearity": 1,
    "planarity": 2,
    "scattering": 3,
    "orientation_to_the_surface": 4,
    "normalized_pixel_height": 5,
    "density": 6,
    "occlusion": 7,
}


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

    def forward(self, x, segment_ids, valid, num_segments: int, ptr=None,
                count=None):
        """``count``: the per-segment number of valid elements, when the
        caller already has it (the mean then takes no count of its own)."""
        if self.reduce == "mean" and count is not None:
            s = seg.segment_sum(x, segment_ids, num_segments, valid, ptr)
            return s / torch.clamp(count, min=1.0)[:, None]
        return seg.segment_reduce(x, segment_ids, num_segments, self.reduce,
                                  valid, ptr)


class HeuristicPool(nn.Module):
    """Pick one view per point by arg-extremum of a named mapping feature
    (``HeuristicBimodalCSRPool``, pooling.py:74): the first valid view of
    least ``normalized_depth`` by default; an empty segment gives 0."""

    def __init__(self, feature: str = "normalized_depth",
                 mode: str = "argmin"):
        super().__init__()
        self.feature = feature
        self.mode = mode

    def forward(self, x, x_map, segment_ids, valid, num_segments: int,
                ptr=None):
        key = x_map[:, VIEW_FEATURE_INDEX[self.feature]]
        fn = (seg.segment_argmin if self.mode == "argmin"
              else seg.segment_argmax)
        arg, nonempty = fn(key, segment_ids, num_segments, valid, ptr)
        return torch.where(nonempty[:, None], x[arg], 0.0)


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


class MinMaxDiffSetFeat(nn.Module):
    """Element-wise set features from difference-to-min / difference-to-max
    / set size (ref ``MinMaxDiffSetFeat``, pooling.py:554-601): each element
    is concatenated with ``x - min(set)`` and ``x - max(set)`` (and, with
    ``use_num``, ``sqrt(1/(n + 1e-3))``), then embedded by the bias-free
    masked-BN MLP."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_min: bool = True, use_max: bool = True,
                 use_num: bool = False, device=None):
        super().__init__()
        self.use_min = use_min
        self.use_max = use_max
        self.use_num = use_num
        width = in_channels * (1 + int(use_min) + int(use_max)) + int(use_num)
        self.mlp = MLP(width, [out_channels, out_channels], device=device)

    def forward(self, x, segment_ids, valid, num_segments: int, ptr=None,
                seg_valid=None, count=None):
        parts = [x]
        if self.use_min:
            mn = seg.segment_min(x, segment_ids, num_segments, valid, ptr)
            parts.append(x - mn[segment_ids])
        if self.use_max:
            mx = seg.segment_max(x, segment_ids, num_segments, valid, ptr)
            parts.append(x - mx[segment_ids])
        if self.use_num:
            n = count
            if n is None:
                n = seg.segment_count(segment_ids, num_segments, valid, ptr)
            parts.append(torch.sqrt(1.0 / (n + 1e-3))[segment_ids][:, None])
        return self.mlp(torch.cat(parts, dim=-1), valid)


def _set_encoder(kind: str, in_channels: int, out_channels: int,
                 use_num: bool, pool_modes, fusion, device):
    """The map-feature set encoder of an attention pool (ref ``map_encoder``
    option, pooling.py:372): ``deepset``, ``minmaxdiff`` or ``mlp`` (the
    plain per-element ``MLPSetFeat``, pooling.py:676)."""
    if kind == "deepset":
        return DeepSetFeat(in_channels, out_channels, pool_modes, fusion,
                           use_num, device=device)
    if kind == "minmaxdiff":
        return MinMaxDiffSetFeat(in_channels, out_channels, device=device)
    if kind == "mlp":
        return MLP(in_channels, [out_channels, out_channels], device=device)
    raise ValueError(f"set_encoder {kind!r}")


def _encode(enc, x_map, segment_ids, valid, num_segments, ptr, seg_valid,
            count):
    if isinstance(enc, MLP):
        return enc(x_map, valid)
    return enc(x_map, segment_ids, valid, num_segments, ptr=ptr,
               seg_valid=seg_valid, count=count)


def _uses_count(enc) -> bool:
    return isinstance(enc, (DeepSetFeat, MinMaxDiffSetFeat)) and enc.use_num


class GroupViewPool(nn.Module):
    """The paper's attention pooling (``GroupBimodalCSRPool``,
    pooling.py:159-319).  Returns ``(pooled [S, C], attention [E, G])``."""

    def __init__(self, in_channels: int, out_channels: int,
                 map_channels: int = 8, num_groups: int = 1,
                 set_channels: int = 32, use_mod: bool = False,
                 gated: bool = True, scaling: bool = True,
                 use_num: bool = True, enc_pool: Sequence[str] = ("max",),
                 enc_fusion: str = "concatenation",
                 set_encoder: str = "deepset", device=None):
        super().__init__()
        self.num_groups = num_groups
        self.out_channels = out_channels
        self.use_mod = use_mod
        self.gated = gated
        self.scaling = scaling
        self.set_enc = _set_encoder(set_encoder, map_channels, set_channels,
                                    use_num, enc_pool, enc_fusion, device)
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
        if count is None and (_uses_count(self.set_enc) or self.scaling):
            count = seg.segment_count(segment_ids, num_segments, valid, ptr)
        enc = _encode(self.set_enc, x_map, segment_ids, valid, num_segments,
                      ptr, seg_valid, count)
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


class QKVViewPool(nn.Module):
    """Query(3D)-Key(map) attention pooling (``QKVBimodalCSRPool``,
    pooling.py:322-553).  Queries come from the 3D point features
    ``x_main [num_segments - 1, main_channels]`` (a zero query row is
    appended for the drop segment), keys from the set-encoded map features;
    per-group dot-product scores, divided by ``sqrt(qk_channels)`` with
    ``dim_scaling``, then the softmax / weighted-sum / gating tail of
    :class:`GroupViewPool`.  ``use_mod_q`` / ``use_mod_k`` mix the value
    embedding into the query / key paths through an ``E_mix`` MLP whose
    hidden width is ``nearest_power_of_2((in + out) / 2, out * 2)``; with
    ``use_mod_q`` the queries are per view.  Returns ``(pooled [S, C],
    attention [E, G])``."""

    def __init__(self, main_channels: int, in_channels: int,
                 out_channels: int, map_channels: int = 8,
                 num_groups: int = 1, qk_channels: int = 8,
                 set_channels: int = 32, gated: bool = True,
                 scaling: bool = False, dim_scaling: bool = True,
                 use_mod_q: bool = False, use_mod_k: bool = False,
                 set_encoder: str = "deepset", use_num: bool = True,
                 enc_pool: Sequence[str] = ("max",),
                 enc_fusion: str = "concatenation", device=None):
        super().__init__()
        g, c, d, nc = num_groups, out_channels, qk_channels, set_channels
        self.num_groups, self.out_channels, self.qk_channels = g, c, d
        self.gated = gated
        self.scaling = scaling
        self.dim_scaling = dim_scaling
        self.use_mod_q = use_mod_q
        self.use_mod_k = use_mod_k
        self.e_main = MLP(main_channels, [nc, nc], device=device)
        self.key_enc = _set_encoder(set_encoder, map_channels, nc, use_num,
                                    enc_pool, enc_fusion, device)
        self.e_mod = MLP(in_channels, [c, c], device=device)
        mid = nearest_power_of_2((nc + c + nc) / 2, nc * 2)
        if use_mod_k:
            self.e_mix_k = MLP(nc + c, [mid, nc], device=device)
        if use_mod_q:
            self.e_mix_q = MLP(nc + c, [mid, nc], device=device)
        self.k = nn.Linear(nc, g * d, device=device)
        self.q = nn.Linear(nc, g * d, device=device)
        if gated:
            self.gating = Gating(g, device=device)

    def forward(self, x_main, x_mod, x_map, segment_ids, valid,
                num_segments: int, ptr=None, seg_valid=None, count=None):
        """``count``: the per-segment number of valid elements, when the
        caller already has it; the compatibilities' maximum serves the
        softmax's shift (detached) and the gating (with its gradient)."""
        g, c, d = self.num_groups, self.out_channels, self.qk_channels
        if count is None and (_uses_count(self.key_enc) or self.scaling):
            count = seg.segment_count(segment_ids, num_segments, valid, ptr)
        x_main_emb = self.e_main(x_main)
        pad = num_segments - x_main_emb.shape[0]
        enc = _encode(self.key_enc, x_map, segment_ids, valid, num_segments,
                      ptr, seg_valid, count)
        values = self.e_mod(x_mod, valid)
        if self.use_mod_k:
            enc = self.e_mix_k(torch.cat([enc, values], dim=-1), valid)
        k = self.k(enc).reshape(-1, g, d)
        if self.use_mod_q:
            x_main_v = F.pad(x_main_emb, (0, 0, 0, pad))[segment_ids]
            q = self.q(self.e_mix_q(torch.cat([x_main_v, values], dim=-1),
                                    valid)).reshape(-1, g, d)
        else:
            queries = F.pad(self.q(x_main_emb), (0, 0, 0, pad))
            q = queries.reshape(num_segments, g, d)[segment_ids]
        compat = torch.sum(q * k, dim=-1)                          # [E, G]
        if self.dim_scaling:
            compat = compat / torch.sqrt(torch.tensor(
                float(d), dtype=torch.float32, device=compat.device))
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
