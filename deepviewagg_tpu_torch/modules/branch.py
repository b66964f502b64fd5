"""The unimodal (image) branch: 2D tower -> gather -> pool -> fuse.

The port of ``deepviewagg_tpu/modules/branch.py`` (``ModalityDropout``,
``UnimodalBranch``; the reference's ``UnimodalBranch``,
modules/multimodal/modules.py:249-568):

    2D CNN on the image batch
    -> per-mapped-pixel feature gather (nearest or bilinear-interpolate)
    -> atomic pooling   (pixels -> view,  sorted-segment reduce)
    -> view pooling     (views  -> point, the DeepViewAgg group attention)
    -> modality dropout (all-or-nothing, modules/multimodal/dropout.py)
    -> fusion into the 3D stream

plus the ``x_seen`` mask (points that any valid view reaches,
modules.py:410).  Every dropout draws from the ``torch.Generator`` the caller
passes down (the counterpart of flax's ``rngs={"dropout": rng}``); without
one, every dropout is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import segment as seg
from .fusion import BimodalFusion
from .gather import gather_pixel_features
from .image_encoders import run_tower
from .pooling import GroupViewPool

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
    """One image branch at one fusion point with the group view pool.

    ``tower`` is a module mapping channels-first images to feature maps with
    ``tower_channels`` channels; ``channels_3d`` is the width of the 3D
    stream it fuses into.
    """

    def __init__(self, tower: nn.Module, tower_channels: int,
                 channels_3d: int, out_channels: int,
                 atomic_reduce: str = "max", num_groups: int = 1,
                 use_mod: bool = False, pool_use_num: bool = True,
                 pool_scaling: bool = True,
                 pool_modes: Tuple[str, ...] = ("max",),
                 pool_fusion: str = "concatenation", gated: bool = True,
                 interpolate: bool = True, drop_modality: float = 0.0,
                 drop_3d: float = 0.0, drop_hard: bool = True,
                 fusion_mode: str = "residual", tower_bf16: bool = True, pool_bf16: bool = False,
                 device=None):
        super().__init__()
        self.tower = tower
        self.atomic_reduce = atomic_reduce
        self.interpolate = interpolate
        self.tower_bf16 = tower_bf16
        self.pool_bf16 = pool_bf16
        self.drop_modality = drop_modality
        self.drop_3d = drop_3d
        # hard: all-or-nothing ModalityDropout; soft: per-element dropout on
        # the pooled features (ref modules.py:272)
        self.drop_hard = drop_hard
        self.mod_drop = ModalityDropout(drop_modality)
        self.drop_3d_mod = ModalityDropout(drop_3d)
        self.view_pool = GroupViewPool(
            tower_channels, out_channels, num_groups=num_groups,
            use_mod=use_mod, gated=gated, scaling=pool_scaling,
            use_num=pool_use_num, enc_pool=pool_modes, enc_fusion=pool_fusion,
            device=device)
        self.fusion = BimodalFusion(fusion_mode, channels_3d, out_channels,
                                    device=device)
        self.out_channels = self.fusion.out_channels

    def forward(self, x_3d: torch.Tensor, images: torch.Tensor, mapping: dict,
                ref_size, num_points: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        vc = mapping["view_valid"].shape[0]
        if x_3d is not None:
            num_points = x_3d.shape[0]

        feats_2d = run_tower(self.tower, images, bf16=self.tower_bf16,
                             out_f32=not (self.pool_bf16 and self.tower_bf16))

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
        v_valid = mapping["view_valid"]
        # segment-level BN statistics exclude the padding drop row
        seg_ok = torch.arange(num_points + 1, device=pid.device) < num_points
        pooled, _ = self.view_pool(
            x_view, mapping["view_feats"], pid, v_valid, num_points + 1,
            ptr=mapping.get("point_ptr"), seg_valid=seg_ok)
        pooled = pooled[:num_points]

        # --- x_seen (modules.py:410) -------------------------------------
        n_views = seg.segment_count(pid, num_points + 1, v_valid)[:num_points]
        x_seen = n_views > 0

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
        return out, x_seen
