"""Crop-size families: per-image power-of-two crops, bucketed.

The reference's ``CropImageGroups`` (data_transform/multimodal/image.py:
1040-1141): each image is cropped to the smallest power-of-two size family
containing its mapped-pixel bbox, and images are regrouped per family
(``ImageData`` of several ``SameSettingImageData``).  Static-shape form: a fixed
ladder of crop sizes = static shape buckets; each batch ships one image
tensor and one pixel table per bucket, all referencing ONE global view
table (each view's pixels live in exactly one bucket, so per-bucket atomic
pools sum to the global per-view features).

The port's copy of ``deepviewagg_tpu/data/crop_groups.py``: host numpy only,
byte-identical outputs; the device contract is produced by
:func:`split_mapping_by_bucket`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .mapping import MultiViewMapping

__all__ = ["crop_ladder", "assign_crop_groups", "split_mapping_by_bucket"]


def crop_ladder(max_size: Tuple[int, int], min_size: int = 64) -> List[Tuple[int, int]]:
    """Power-of-two ladder of (w, h) crops up to the full image size, same
    aspect (image.py:1082-1118's size families)."""
    w, h = max_size
    ladder = [(w, h)]
    while w // 2 >= min_size and h // 2 >= min_size:
        w, h = w // 2, h // 2
        ladder.append((w, h))
    return ladder[::-1]   # small -> large


def _image_bboxes(m: MultiViewMapping):
    vc = m.view_capacity
    pv = np.minimum(m.pix_view, vc - 1)
    img = np.where(m.pix_valid, m.image_id[pv], -1)
    boxes = np.zeros((m.num_images, 4), np.int64)   # x0, y0, x1, y1 (incl)
    for i in range(m.num_images):
        sel = img == i
        if sel.any():
            boxes[i] = [m.pix_x[sel].min(), m.pix_y[sel].min(),
                        m.pix_x[sel].max(), m.pix_y[sel].max()]
        else:
            boxes[i] = [0, 0, 0, 0]
    return boxes


def assign_crop_groups(
    cloud: Dict, ladder: Sequence[Tuple[int, int]],
) -> Dict:
    """Crop each image to the smallest ladder size containing its bbox and
    tag it with its bucket index (``cloud['image_bucket'] [I]``).  Pixel
    coords shift into crop coordinates; crops are centered on the bbox and
    clamped inside the image.  Images keep full-resolution storage until
    :func:`split_mapping_by_bucket` packs per-bucket tensors.
    """
    m: MultiViewMapping = cloud["mapping"]
    images = cloud["images"]
    full_w, full_h = images.shape[1], images.shape[2]
    boxes = _image_bboxes(m)
    bucket_of = np.zeros(m.num_images, np.int64)
    origins = np.zeros((m.num_images, 2), np.int64)
    for i in range(m.num_images):
        x0, y0, x1, y1 = boxes[i]
        bw, bh = x1 - x0 + 1, y1 - y0 + 1
        bi = len(ladder) - 1
        for j, (cw, ch) in enumerate(ladder):
            if bw <= cw and bh <= ch:
                bi = j
                break
        cw, ch = ladder[bi]
        cw, ch = min(cw, full_w), min(ch, full_h)
        cx = int(np.clip((x0 + x1) // 2, cw // 2, full_w - (cw - cw // 2)))
        cy = int(np.clip((y0 + y1) // 2, ch // 2, full_h - (ch - ch // 2)))
        bucket_of[i] = bi
        origins[i] = [cx - cw // 2, cy - ch // 2]
    out = dict(cloud)
    out["image_bucket"] = bucket_of
    out["crop_origin"] = origins
    return out


def split_mapping_by_bucket(
    cloud: Dict, ladder: Sequence[Tuple[int, int]],
    include_images: bool = True,
) -> Dict:
    """Produce per-bucket image tensors + pixel tables (host arrays).

    Returns ``{"view": <view-level arrays>, "buckets": [per bucket:
    {"images" [Ib, w, h, 3], "pix_view", "pix_x", "pix_y", "pix_valid",
    "image_id_of_view_remap"...}]}`` where every bucket's ``pix_view``
    points into the GLOBAL view table and per-bucket ``image_id`` is the
    view's image renumbered within its bucket.
    """
    m: MultiViewMapping = cloud["mapping"]
    images = cloud["images"]
    full_w, full_h = images.shape[1], images.shape[2]
    bucket_of = cloud["image_bucket"]
    origins = cloud["crop_origin"]
    vc = m.view_capacity
    pv = np.minimum(m.pix_view, vc - 1)
    pix_img = np.where(m.pix_valid, m.image_id[pv], -1)

    buckets = []
    for bi, (cw, ch) in enumerate(ladder):
        cw, ch = min(cw, full_w), min(ch, full_h)
        img_ids = np.nonzero(bucket_of == bi)[0]
        local = np.full(m.num_images, -1, np.int64)
        local[img_ids] = np.arange(len(img_ids))
        crops = None
        if include_images:
            crops = np.zeros((len(img_ids), cw, ch, images.shape[3]),
                             images.dtype)
            for li, gi in enumerate(img_ids):
                x0, y0 = origins[gi]
                crops[li] = images[gi, x0:x0 + cw, y0:y0 + ch]
        # pixels of views whose image lives in this bucket
        sel = np.isin(pix_img, img_ids) & m.pix_valid
        gx = m.pix_x[sel].astype(np.int64)
        gy = m.pix_y[sel].astype(np.int64)
        gi = pix_img[sel]
        nx = np.clip(gx - origins[gi, 0], 0, cw - 1)
        ny = np.clip(gy - origins[gi, 1], 0, ch - 1)
        bucket = {
            "size": (cw, ch),
            "pix_view": m.pix_view[sel].astype(np.int32),
            "pix_x": nx.astype(np.int32),
            "pix_y": ny.astype(np.int32),
            "pix_valid": np.ones(sel.sum(), bool),
            # per-pixel local image index inside this bucket's tensor
            "pix_image": local[gi].astype(np.int32),
        }
        if crops is not None:
            bucket["images"] = crops
        buckets.append(bucket)
    return {
        "view": {
            "point_id": m.point_id, "image_id": m.image_id,
            "view_feats": m.view_feats, "view_valid": m.view_valid,
            # CSR pointer of the sorted point_id column (segment_csr indptr)
            # so the view pool's segment kernel skips an on-device searchsorted
            "point_ptr": np.searchsorted(
                m.point_id, np.arange(m.num_points + 2)
            ).astype(np.int32),
        },
        "buckets": buckets,
        "num_points": m.num_points,
    }
