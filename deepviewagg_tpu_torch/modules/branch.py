"""The unimodal (image) branch: 2D tower -> gather -> pool -> fuse, eval path.

The port of ``deepviewagg_tpu/modules/branch.py::UnimodalBranch`` (the
reference's ``UnimodalBranch``, modules/multimodal/modules.py:249-568):

    2D CNN on the image batch
    -> per-mapped-pixel feature gather (nearest or bilinear-interpolate)
    -> atomic pooling   (pixels -> view,  sorted-segment reduce)
    -> view pooling     (views  -> point, the DeepViewAgg group attention)
    -> fusion into the 3D stream

plus the ``x_seen`` mask (points that any valid view reaches,
modules.py:410).  Modality dropout is the identity in eval mode, so it has no
module here.
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

__all__ = ["UnimodalBranch"]


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
                 interpolate: bool = True, fusion_mode: str = "residual",
                 tower_bf16: bool = True, pool_bf16: bool = False,
                 device=None):
        super().__init__()
        self.tower = tower
        self.atomic_reduce = atomic_reduce
        self.interpolate = interpolate
        self.tower_bf16 = tower_bf16
        self.pool_bf16 = pool_bf16
        self.view_pool = GroupViewPool(
            tower_channels, out_channels, num_groups=num_groups,
            use_mod=use_mod, gated=gated, scaling=pool_scaling,
            use_num=pool_use_num, enc_pool=pool_modes, enc_fusion=pool_fusion,
            device=device)
        self.fusion = BimodalFusion(fusion_mode, channels_3d, out_channels,
                                    device=device)
        self.out_channels = self.fusion.out_channels

    def forward(self, x_3d: torch.Tensor, images: torch.Tensor, mapping: dict,
                ref_size, num_points: Optional[int] = None):
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
        out = pooled if x_3d is None else self.fusion(x_3d, pooled)
        return out, x_seen
