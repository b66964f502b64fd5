"""Multi-bucket image branch: crop-size families on device.

The port of ``deepviewagg_tpu/modules/multibucket.py`` and the device
counterpart of :mod:`deepviewagg_tpu_torch.data.crop_groups`: the batch
carries one image tensor + pixel table per crop-size bucket, all referencing
a single global view table.  The 2D tower (shared parameters) runs per
bucket; per-bucket atomic pools are summed into the global per-view features
— exact because each view's pixels live in exactly one bucket and empty
segments reduce to 0 (`ops/segment.py`).

This is the reference's ``ImageData``-of-``SameSettingImageData`` forward
(multi crop families per sample, modules/multimodal/modules.py:442-539 +
view_cat machinery image.py:1550-1616) in static-shape form.

The module follows the JAX package's ``MultiBucketBranch`` where that differs
from ``UnimodalBranch``: the group view pool takes its default options
(``use_mod`` off, size feature and softmax scaling on, max-pooled set
encoder) and no ``seg_valid``, so the set encoder's masked batch norm counts
the padding drop segment; there is no modality or 3D dropout; ``interpolate``
is accepted and not read (the gather indexes exactly at scale 1 and samples
bilinearly otherwise).  Its sub-modules carry the names of
``UnimodalBranch``'s (``tower``, ``view_pool``, ``fusion``), so one set of
parameters serves both kinds of batch (:meth:`MultiBucketBranch.over`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import segment as seg
from .fusion import BimodalFusion
from .gather import _bilinear, _bilinear_upsampled, _rows, _use_upsample
from .image_encoders import run_tower
from .pooling import DeepSetFeat, GroupViewPool, SegmentPool

__all__ = ["MultiBucketBranch"]


class MultiBucketBranch(nn.Module):
    """Image branch over crop-group buckets.

    ``mm["view"]`` holds the global view table; ``mm["buckets"]`` a list of
    ``{pix_view, pix_x, pix_y, pix_valid, pix_image, pix_ptr}`` (and
    optionally ``images [Ib, w, h, 3]``) — note pixels carry their local
    image index directly (no view->image lookup needed).

    ``tower`` maps channels-first images to feature maps with
    ``tower_channels`` channels (None: the images are the feature maps);
    ``channels_3d`` is the width of the 3D stream the branch fuses into.
    ``view_pool`` is ``'group'`` (the attention pool) or a reduction name of
    :class:`SegmentPool`.
    """

    def __init__(self, tower: Optional[nn.Module], tower_channels: int,
                 channels_3d: int, out_channels: int,
                 atomic_reduce: str = "max", view_pool: str = "group",
                 num_groups: int = 1, gated: bool = True,
                 interpolate: bool = True, fusion_mode: str = "residual",
                 frozen: bool = False, remat_tower=False,
                 tower_bf16: bool = True, pool_bf16: bool = False,
                 device=None):
        super().__init__()
        self.tower = tower
        if view_pool == "group":
            self.view_pool = GroupViewPool(
                tower_channels, out_channels, num_groups=num_groups,
                gated=gated, device=device)
            pooled_channels = out_channels
        else:
            self.view_pool = SegmentPool(view_pool)
            pooled_channels = tower_channels
        self.fusion = BimodalFusion(fusion_mode, channels_3d, pooled_channels,
                                    device=device)
        self._configure(atomic_reduce, interpolate, frozen, remat_tower,
                        tower_bf16, pool_bf16)

    def _configure(self, atomic_reduce, interpolate, frozen, remat_tower,
                   tower_bf16, pool_bf16):
        self.atomic_reduce = atomic_reduce
        self.interpolate = interpolate
        self.frozen = frozen            # frozen pretrained tower
        self.remat_tower = remat_tower  # False | True | 'convs' (run_tower)
        self.tower_bf16 = tower_bf16
        # keep the pixel gather in bf16; the per-view features are float32
        # from the atomic pool on, so attention/fusion math is unchanged
        self.pool_bf16 = pool_bf16
        self.out_channels = self.fusion.out_channels

    @classmethod
    def over(cls, branch: nn.Module) -> "MultiBucketBranch":
        """The ladder form of a ``UnimodalBranch``: a branch over the same
        ``tower``, ``view_pool`` and ``fusion`` modules (no parameter of its
        own) and with the same tower options.  The JAX package's ladder
        branch takes the group pool or a ``SegmentPool`` reduction only, and
        builds its group pool with the default options whatever the
        branch's spec says, so a pool with other options has another
        parameter tree there and is refused here."""
        pool = branch.view_pool
        if not isinstance(pool, (GroupViewPool, SegmentPool)):
            raise ValueError(
                f"the {type(pool).__name__} view pool has no crop-ladder "
                "form: the JAX package's ladder branch takes the group pool "
                "and the SegmentPool reductions only")
        if isinstance(pool, GroupViewPool) and (
                pool.use_mod or not pool.scaling
                or not isinstance(pool.set_enc, DeepSetFeat)
                or not pool.set_enc.use_num
                or pool.set_enc.pool_modes != ("max",)
                or pool.set_enc.fusion != "concatenation"):
            raise ValueError(
                "a crop-ladder batch takes the group view pool with its "
                "default options (use_mod off, use_num and scaling on, "
                "max-pooled set encoder with concatenation)")
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.tower = branch.tower
        self.view_pool = branch.view_pool
        self.fusion = branch.fusion
        self._configure(branch.atomic_reduce, branch.interpolate,
                        branch.frozen, branch.remat_tower, branch.tower_bf16,
                        branch.pool_bf16)
        return self

    def forward(self, x_3d: Optional[torch.Tensor], mm: Dict,
                num_points: Optional[int] = None, bucket_images=None):
        """``bucket_images``: per-bucket image tensors shared across fusion
        levels (``batch['bucket_images']``); falls back to images embedded in
        the bucket dicts."""
        view = mm["view"]
        vc = view["view_valid"].shape[0]
        if x_3d is not None:
            num_points = x_3d.shape[0]

        x_view = None
        for b, bucket in enumerate(mm["buckets"]):
            images = (bucket["images"] if "images" in bucket
                      else bucket_images[b])
            if images.shape[0] == 0:
                continue
            if self.tower is not None:
                feats_2d = run_tower(
                    self.tower, images, self.training,
                    remat=self.remat_tower, frozen=self.frozen,
                    bf16=self.tower_bf16,
                    out_f32=not (self.pool_bf16 and self.tower_bf16))
            else:
                feats_2d = images
            ref_size = (images.shape[1], images.shape[2])
            pix_feats = self._gather(feats_2d, bucket, ref_size)
            partial = seg.segment_reduce(
                pix_feats.to(torch.float32), bucket["pix_view"], vc + 1,
                self.atomic_reduce, valid=bucket["pix_valid"],
                ptr=bucket.get("pix_ptr"),
            )[:vc]
            x_view = partial if x_view is None else x_view + partial
        if x_view is None:
            raise ValueError("no bucket carries images")

        pid = view["point_id"]
        p_ptr = view.get("point_ptr")
        v_valid = view["view_valid"]
        # valid views per point, counted once: the pool's size feature and
        # softmax scaling, and x_seen below
        n_views = seg.segment_count(pid, num_points + 1, v_valid, p_ptr)
        if isinstance(self.view_pool, GroupViewPool):
            pooled, _ = self.view_pool(
                x_view, view["view_feats"], pid, v_valid, num_points + 1,
                ptr=p_ptr, count=n_views)
        else:
            pooled = self.view_pool(x_view, pid, v_valid, num_points + 1,
                                    ptr=p_ptr, count=n_views)
        pooled = pooled[:num_points]
        x_seen = n_views[:num_points] > 0
        if x_3d is None:
            return pooled, x_seen
        return self.fusion(x_3d, pooled), x_seen

    @staticmethod
    def _gather(feature_maps: torch.Tensor, bucket: Dict, ref_size):
        """Bilinear sample at pixel coords with a per-pixel image index —
        same convention as :func:`modules.gather.gather_pixel_features`
        (ref sparse_interpolation, image.py:105-170: coords / (size - 1),
        scale by the feature-map size, border padding; EXACT indexing at
        scale 1 per the reference's ``interpolate and scale != 1`` guard).

        Scale 1: flat-index rows on a ``[I*Wf*Hf, C]`` view; else the dense
        separable upsample plus one row gather where ``_use_upsample`` says
        so, else four flat-index tap gathers; all three shared with
        :mod:`modules.gather`.  Invalid rows give 0."""
        i_cap, wf, hf, c = feature_maps.shape
        w, h = ref_size
        img_id = torch.clamp(bucket["pix_image"], 0, i_cap - 1)
        px, py, valid = bucket["pix_x"], bucket["pix_y"], bucket["pix_valid"]
        if (wf, hf) == (w, h):
            flat = feature_maps.reshape(-1, c)
            idx = (img_id.to(torch.int64) * (wf * hf)
                   + px.to(torch.int64) * hf + py.to(torch.int64))
            out = _rows(flat, idx)
            return out * valid[:, None].to(out.dtype)
        if _use_upsample(i_cap, w, h, c, px.shape[0],
                         feature_maps.element_size()):
            return _bilinear_upsampled(
                feature_maps, img_id, px.to(torch.int64), py.to(torch.int64),
                w, h, valid=valid)
        xf = px.to(torch.float32) / max(w - 1, 1) * wf - 0.5
        yf = py.to(torch.float32) / max(h - 1, 1) * hf - 0.5
        out = _bilinear(feature_maps, img_id, xf, yf)
        return out * valid[:, None].to(out.dtype)
