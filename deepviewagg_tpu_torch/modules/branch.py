"""The unimodal (image) branch: 2D tower -> gather -> pool -> fuse.

The port of ``deepviewagg_tpu/modules/branch.py`` (``ModalityDropout``,
``UnimodalBranch``; the reference's ``UnimodalBranch``,
modules/multimodal/modules.py:249-568):

    2D CNN on the image batch
    -> per-mapped-pixel feature gather (nearest or bilinear-interpolate)
    -> atomic pooling   (pixels -> view,  sorted-segment reduce)
    -> view pooling     (views  -> point: the DeepViewAgg group attention,
                         QKV attention, a heuristic pick or a reduction)
    -> modality dropout (all-or-nothing, modules/multimodal/dropout.py)
    -> fusion into the 3D stream

plus the ``x_seen`` mask (points that any valid view reaches,
modules.py:410) and, with ``keep_last_view``, the view-level extras of the
view loss (modules.py:527-534).  Every dropout draws from the
``torch.Generator`` the caller passes down (the counterpart of flax's
``rngs={"dropout": rng}``); without one, every dropout is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import segment as seg
from .fusion import BimodalFusion
from .gather import gather_pixel_features
from .image_encoders import run_tower
from .pooling import GroupViewPool, HeuristicPool, QKVViewPool, SegmentPool

__all__ = ["UnimodalBranch", "ModalityDropout", "soft_dropout"]


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform [0, 1) draws of ``generator`` (on its own device), moved to
    ``device`` without a host synchronisation."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


class ModalityDropout(nn.Module):
    """All-or-nothing branch dropout (dropout.py:5-15): with probability
    ``p`` the whole modality contribution is zeroed for the entire forward,
    else rescaled by ``1 / (1 - p)`` (the standard inverted convention).
    The identity when ``p <= 0`` or no generator is given; active whenever a
    generator is given, at train and eval alike (the MC-dropout voting
    mode)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.p <= 0.0 or generator is None:
            return x
        keep = _uniform((), generator, x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def soft_dropout(x, p: float, generator: Optional[torch.Generator]):
    """Per-element inverted dropout drawing from ``generator`` (``nn.Dropout``
    takes none); the identity when ``p <= 0`` or no generator is given."""
    if p <= 0.0 or generator is None:
        return x
    keep = _uniform(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class UnimodalBranch(nn.Module):
    """One image branch at one fusion point.

    ``tower`` is a module mapping channels-first images to feature maps with
    ``tower_channels`` channels; ``channels_3d`` is the width of the 3D
    stream it fuses into (0 where there is none: the no3d family).
    ``view_pool`` picks the aggregation: ``'group'`` (the paper's attention),
    ``'qkv'`` (queries from the 3D stream), ``'heuristic'`` (the closest
    view) or a :class:`SegmentPool` reduction (``'max'``, ``'mean'``, ...).
    The forward returns ``(out, x_seen)``, and with ``keep_last_view`` also
    the view-level extras ``{x_view, attention, view_point_id, view_valid}``.
    """

    def __init__(self, tower: nn.Module, tower_channels: int,
                 channels_3d: int, out_channels: int,
                 atomic_reduce: str = "max", view_pool: str = "group",
                 num_groups: int = 1,
                 use_mod: bool = False, set_encoder: str = "deepset",
                 pool_use_num: bool = True,
                 pool_scaling: bool = True,
                 pool_modes: Tuple[str, ...] = ("max",),
                 pool_fusion: str = "concatenation", qk_channels: int = 8,
                 use_mod_q: bool = False, use_mod_k: bool = False,
                 dim_scaling: bool = True, gated: bool = True,
                 interpolate: bool = True, drop_modality: float = 0.0,
                 drop_3d: float = 0.0, drop_hard: bool = True,
                 fusion_mode: str = "residual", tower_bf16: bool = True,
                 pool_bf16: bool = False, remat_tower=False,
                 frozen: bool = False, keep_last_view: bool = False,
                 device=None):
        super().__init__()
        self.tower = tower
        self.atomic_reduce = atomic_reduce
        self.interpolate = interpolate
        self.tower_bf16 = tower_bf16
        self.pool_bf16 = pool_bf16
        self.remat_tower = remat_tower  # False | True | 'convs' (run_tower)
        self.frozen = frozen            # frozen pretrained tower
        self.drop_modality = drop_modality
        self.drop_3d = drop_3d
        # hard: all-or-nothing ModalityDropout; soft: per-element dropout on
        # the pooled features (ref modules.py:272)
        self.drop_hard = drop_hard
        self.keep_last_view = keep_last_view
        self.mod_drop = ModalityDropout(drop_modality)
        self.drop_3d_mod = ModalityDropout(drop_3d)
        pooled_channels = out_channels
        if view_pool == "group":
            self.view_pool = GroupViewPool(
                tower_channels, out_channels, num_groups=num_groups,
                use_mod=use_mod, gated=gated, scaling=pool_scaling,
                use_num=pool_use_num, enc_pool=pool_modes,
                enc_fusion=pool_fusion, set_encoder=set_encoder,
                device=device)
        elif view_pool == "qkv":
            if channels_3d <= 0:
                raise ValueError("the qkv view pool takes its queries from "
                                 "the 3D stream; this branch has none")
            self.view_pool = QKVViewPool(
                channels_3d, tower_channels, out_channels,
                num_groups=num_groups, qk_channels=qk_channels, gated=gated,
                scaling=pool_scaling, dim_scaling=dim_scaling,
                use_mod_q=use_mod_q, use_mod_k=use_mod_k,
                set_encoder=set_encoder, use_num=pool_use_num,
                enc_pool=pool_modes, enc_fusion=pool_fusion, device=device)
        elif view_pool == "heuristic":
            self.view_pool = HeuristicPool()
            pooled_channels = tower_channels
        else:
            self.view_pool = SegmentPool(view_pool)
            pooled_channels = tower_channels
        self.fusion = BimodalFusion(fusion_mode, channels_3d, pooled_channels,
                                    device=device)
        self.out_channels = self.fusion.out_channels

    def forward(self, x_3d: torch.Tensor, images: torch.Tensor, mapping: dict,
                ref_size, num_points: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        vc = mapping["view_valid"].shape[0]
        if x_3d is not None:
            num_points = x_3d.shape[0]

        feats_2d = run_tower(self.tower, images, self.training,
                             remat=self.remat_tower, frozen=self.frozen,
                             bf16=self.tower_bf16,
                             out_f32=not (self.pool_bf16 and self.tower_bf16),
                             generator=generator)

        # --- pixels -> views (atomic pool) -------------------------------
        pix_feats = gather_pixel_features(feats_2d, mapping, ref_size,
                                          interpolate=self.interpolate)
        x_view = seg.segment_reduce(
            pix_feats.to(torch.float32), mapping["pix_view"], vc + 1,
            self.atomic_reduce, valid=mapping["pix_valid"],
            ptr=mapping.get("pix_ptr"),
        )[:vc]

        # --- views -> points (view pool) ---------------------------------
        pid = mapping["point_id"]
        p_ptr = mapping.get("point_ptr")
        v_valid = mapping["view_valid"]
        s = num_points + 1
        # segment-level BN statistics exclude the padding drop row
        seg_ok = torch.arange(s, device=pid.device) < num_points
        # valid views per point, counted once: the pool's size feature,
        # softmax scaling or mean, and x_seen below
        n_views = seg.segment_count(pid, s, v_valid, p_ptr)
        attn = None
        pool = self.view_pool
        if isinstance(pool, GroupViewPool):
            pooled, attn = pool(x_view, mapping["view_feats"], pid, v_valid,
                                s, ptr=p_ptr, seg_valid=seg_ok,
                                count=n_views)
        elif isinstance(pool, QKVViewPool):
            pooled, attn = pool(x_3d, x_view, mapping["view_feats"], pid,
                                v_valid, s, ptr=p_ptr, seg_valid=seg_ok,
                                count=n_views)
        elif isinstance(pool, HeuristicPool):
            pooled = pool(x_view, mapping["view_feats"], pid, v_valid, s,
                          ptr=p_ptr)
        else:
            pooled = pool(x_view, pid, v_valid, s, ptr=p_ptr, count=n_views)
        pooled = pooled[:num_points]

        # --- x_seen (modules.py:410) -------------------------------------
        x_seen = n_views[:num_points] > 0

        # --- modality dropout + fusion -----------------------------------
        if self.drop_hard:
            pooled = self.mod_drop(pooled, generator)
            if x_3d is not None:
                x_3d = self.drop_3d_mod(x_3d, generator)
        else:
            # the soft dropouts are active in training mode only
            soft = generator if self.training else None
            pooled = soft_dropout(pooled, self.drop_modality, soft)
            if x_3d is not None:
                x_3d = soft_dropout(x_3d, self.drop_3d, soft)
        out = pooled if x_3d is None else self.fusion(x_3d, pooled)
        if self.keep_last_view:
            return out, x_seen, {"x_view": x_view, "attention": attn,
                                 "view_point_id": pid, "view_valid": v_valid}
        return out, x_seen
