"""Collation: samples -> one static-shape device batch.

The TPU counterpart of ``MMBatch.from_mm_data_list``
(core/multimodal/data.py:179) + the runtime voxel bookkeeping the reference
does *on device* during forward (torchsparse ``sphash`` reindex +
``ImageMapping.select_points``, modules/multimodal/modules.py:101-236).
Here all of it happens host-side, once per batch:

  1. concatenate per-sample voxel arrays (coords already quantized);
  2. build the multi-level UNet graph (kernel maps, parents) padded to the
     bucket's per-level capacities;
  3. concatenate per-sample mappings with point/image offsets, then derive
     the per-branch-level mappings by merging through the parent chain;
  4. pad images/views/pixels to bucket capacities — one flat image batch,
     or, with ``Bucket.image_ladder``, one image tensor and one pixel table
     per crop size (:mod:`.crop_groups`) over a single view table.

A ``Bucket`` pins every static dimension, so batches of one bucket family
share every array shape (SURVEY.md §7 design move 1).
:func:`batch_to_torch` moves a collated batch onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.csr import pad_to
from ..ops import sparse_graph as sg
from ..utils import trace
from .mapping import MultiViewMapping, concatenate_mappings

__all__ = ["Sample", "Bucket", "collate", "device_view", "batch_to_torch"]


def device_view(batch: Dict) -> Dict:
    """The device view of a collated batch: everything except ``meta``
    (which holds host-only cloud keys / ragged origin ids)."""
    return {k: v for k, v in batch.items() if k != "meta"}


@dataclasses.dataclass
class Sample:
    """One training sample (a sphere / cylinder / room of voxelized points)."""

    coords: np.ndarray                 # int32 [n, 3] quantized (level-0 units)
    feats: np.ndarray                  # f32 [n, C]
    labels: np.ndarray                 # int32 [n], -1 ignore
    images: Optional[np.ndarray] = None      # f32 [m, W, H, 3]
    mapping: Optional[MultiViewMapping] = None
    # camera-family index per image (pinhole / fisheye ...): when set, the
    # collate routes each image through its family's native-aspect bucket
    # (ref SameSettingImageData settings groups, image.py:177,1208-1219)
    image_family: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None   # f32 [n, 3] raw positions (trackers)
    origin_id: Optional[np.ndarray] = None   # int64 [n] raw-cloud row ids
    cloud: Optional[str] = None        # source cloud key (vote accumulation)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Static capacities shared by every batch of one bucket family."""

    level_caps: Sequence[int]          # voxel capacity per UNet level
    num_batches: int                   # max samples per batch
    view_cap: int = 0
    pix_cap: int = 0
    image_cap: int = 0
    image_size: Optional[Sequence[int]] = None  # (W, H)
    # crop-group families (CropImageGroups): when set, images are cropped to
    # these ladder sizes and shipped per-bucket with split pixel tables
    image_ladder: Optional[Sequence[Sequence[int]]] = None
    ladder_image_caps: Optional[Sequence[int]] = None
    ladder_pix_caps: Optional[Sequence[int]] = None


def _mappings(samples: List[Sample], bucket: Bucket,
              branch_levels: Sequence[int], graph, n_total: int,
              imgs: np.ndarray):
    """Each branch level's view and pixel tables: the samples' mappings
    concatenated, merged through the graph's parent chain and padded to the
    bucket; on a crop-ladder bucket split per crop size, with the images of
    each crop size, not yet padded (``None`` on a flat bucket)."""
    merged0 = concatenate_mappings(
        [s.mapping for s in samples],
        np.cumsum([0] + [len(s.coords) for s in samples])[:-1], n_total
    ).with_num_points(bucket.level_caps[0])
    if bucket.image_ladder is not None:
        from .crop_groups import assign_crop_groups, split_mapping_by_bucket

        ladder = [tuple(s_) for s_ in bucket.image_ladder]
        # bucket assignment + image crops are level-invariant (pixel
        # coords never change across stride merges) — build them ONCE;
        # per level only the view/pixel tables are recomputed
        padded0 = merged0.pad(bucket.view_cap, bucket.pix_cap)
        if all(s.image_family is not None for s in samples):
            # camera families: each image's bucket is its camera family
            # at the family's native size (origin 0 on the storage
            # canvas), NOT a bbox-fitted crop
            fams = np.concatenate(
                [np.asarray(s.image_family, np.int64) for s in samples]
            ) if samples else np.zeros(0, np.int64)
            cloud0 = {
                "image_bucket": fams,
                "crop_origin": np.zeros((len(fams), 2), np.int64),
            }
        else:
            cloud0 = assign_crop_groups(
                {"mapping": padded0, "images": imgs}, ladder
            )
        mappings = {}
        raw_images = None
        m = merged0
        level = 0
        for lvl in sorted(branch_levels):
            while level < lvl:
                parent = graph.levels[level].parent
                m = m.merge_points(parent, bucket.level_caps[level + 1])
                level += 1
            padded = m.pad(bucket.view_cap, bucket.pix_cap)
            mm = split_mapping_by_bucket(
                {"mapping": padded, "images": imgs,
                 "image_bucket": cloud0["image_bucket"],
                 "crop_origin": cloud0["crop_origin"]},
                ladder, include_images=raw_images is None,
            )
            if raw_images is None:
                raw_images = []
                for bi, bk in enumerate(mm["buckets"]):
                    raw = bk.pop("images")
                    icap = bucket.ladder_image_caps[bi]
                    # check BEFORE pad_to — it silently truncates, and a
                    # truncated tensor would make pix_image rows >= icap
                    # silently gather the wrong image downstream
                    if len(raw) > icap:
                        raise ValueError(
                            f"crop bucket {bi} overflows image cap "
                            f"({len(raw)}/{icap} imgs)"
                        )
                    raw_images.append(raw)
            # pad per-bucket pixel tables to static caps
            for bi, bk in enumerate(mm["buckets"]):
                icap = bucket.ladder_image_caps[bi]
                qcap = bucket.ladder_pix_caps[bi]
                n_img = int(bk["pix_image"].max(initial=-1)) + 1
                if n_img > icap or len(bk["pix_view"]) > qcap:
                    raise ValueError(
                        f"crop bucket {bi} overflows caps "
                        f"({n_img}/{icap} imgs, "
                        f"{len(bk['pix_view'])}/{qcap} pix)"
                    )
                vc = padded.view_capacity
                bk["pix_view"] = pad_to(bk["pix_view"], qcap, fill=vc)
                bk["pix_ptr"] = np.searchsorted(
                    bk["pix_view"], np.arange(vc + 2)
                ).astype(np.int32)
                bk["pix_x"] = pad_to(bk["pix_x"], qcap)
                bk["pix_y"] = pad_to(bk["pix_y"], qcap)
                bk["pix_valid"] = pad_to(bk["pix_valid"], qcap, fill=False)
                bk["pix_image"] = pad_to(bk["pix_image"], qcap)
                bk.pop("size", None)
            mm.pop("num_points")
            mappings[lvl] = mm
        return mappings, raw_images
    mappings = {}
    m = merged0
    level = 0
    for lvl in sorted(branch_levels):
        while level < lvl:
            parent = graph.levels[level].parent
            m = m.merge_points(parent, bucket.level_caps[level + 1])
            level += 1
        mappings[lvl] = m.pad(bucket.view_cap, bucket.pix_cap).to_device()
    return mappings, None


def collate(
    samples: List[Sample],
    bucket: Bucket,
    branch_levels: Sequence[int] = (),
    conv0_kernel: int = 3,
    graph: str = "unet",
) -> Dict:
    """Build the batch dict (everything numpy; :func:`batch_to_torch`
    moves it to the device).  ``graph``: the batch's point structure, the
    UNet's voxel levels and strided convolution maps (``"unet"``) or Point
    Transformer V3's pyramid of serialized pooling clusters (``"ptv3"``,
    3D-only)."""
    assert len(samples) <= bucket.num_batches
    coords, feats, labels, batch_idx = [], [], [], []
    for b, s in enumerate(samples):
        c = np.concatenate(
            [np.full((len(s.coords), 1), b, np.int32), s.coords.astype(np.int32)],
            axis=1,
        )
        coords.append(c)
        feats.append(np.asarray(s.feats, np.float32))
        labels.append(np.asarray(s.labels, np.int32))
    coords = np.concatenate(coords)
    feats = np.concatenate(feats)
    labels = np.concatenate(labels)
    n_total = len(coords)
    cap0 = bucket.level_caps[0]
    if n_total > cap0:
        raise ValueError(f"{n_total} voxels exceed bucket cap {cap0}")

    if graph == "ptv3":
        return _collate_ptv3(samples, bucket, coords, feats, labels,
                             conv0_kernel)
    with trace.span("collate.graph"):
        graph = sg.build_unet_graph(
            coords,
            num_levels=len(bucket.level_caps),
            num_batches=bucket.num_batches,
            conv0_kernel=conv0_kernel,
            capacities=list(bucket.level_caps),
        )
        dev_graph = sg.graph_to_device(graph)

    batch = {
        "feats": pad_to(feats, cap0),
        "labels": pad_to(labels, cap0, fill=-1),
        "graph": dev_graph,
    }
    if all(s.pos is not None for s in samples):
        pos = np.concatenate([np.asarray(s.pos, np.float32) for s in samples])
        batch["pos"] = pad_to(pos, cap0, fill=1e6)  # pads far away

    if branch_levels:
        with trace.span("collate.images"):
            imgs = np.concatenate([s.images for s in samples]).astype(
                np.float32)
        with trace.span("collate.mappings"):
            batch["mappings"], raw_images = _mappings(
                samples, bucket, branch_levels, graph, n_total, imgs)
        with trace.span("collate.images"):
            if raw_images is not None:
                # one tensor a crop size, shared across levels
                batch["bucket_images"] = [
                    pad_to(raw, icap)
                    for raw, icap in zip(raw_images, bucket.ladder_image_caps)]
            else:
                if len(imgs) > bucket.image_cap:
                    raise ValueError(
                        f"{len(imgs)} images exceed cap {bucket.image_cap}"
                    )
                batch["images"] = pad_to(imgs, bucket.image_cap)

    # host-side metadata (never moved to the device)
    batch["meta"] = {
        "num_valid": n_total,
        "num_samples": len(samples),
        "sizes": [len(s.coords) for s in samples],
        # voting support (SaveOriginalPosId semantics, SURVEY.md §A.9)
        "clouds": [s.cloud for s in samples],
        "origin_ids": [s.origin_id for s in samples],
    }
    return batch


def _collate_ptv3(samples, bucket, coords, feats, labels,
                  stem_kernel: int) -> Dict:
    """A Point Transformer V3 batch: no images; each sample's cells
    shifted to non-negative grid coordinates (its own minimum at 0), the
    point pyramid of :func:`..ops.sparse_graph.build_ptv3_graph` with a
    ``stem_kernel``-wide stem map."""
    if bucket.image_cap or any(s.images is not None for s in samples):
        raise ValueError("the PTv3 route takes 3D-only samples")
    start = np.cumsum([0] + [len(s.coords) for s in samples])
    grid = coords.copy()
    for b in range(len(samples)):
        part = grid[start[b]:start[b + 1], 1:]
        part -= part.min(axis=0)
    cap0 = bucket.level_caps[0]
    with trace.span("collate.graph"):
        graph = sg.build_ptv3_graph(grid, len(bucket.level_caps),
                                    bucket.num_batches,
                                    list(bucket.level_caps), stem_kernel)
    batch = {
        "feats": pad_to(feats, cap0),
        "labels": pad_to(labels, cap0, fill=-1),
        "graph": graph,
    }
    if all(s.pos is not None for s in samples):
        pos = np.concatenate([np.asarray(s.pos, np.float32) for s in samples])
        batch["pos"] = pad_to(pos, cap0, fill=1e6)
    batch["meta"] = {
        "num_valid": len(coords),
        "num_samples": len(samples),
        "sizes": [len(s.coords) for s in samples],
        "clouds": [s.cloud for s in samples],
        "origin_ids": [s.origin_id for s in samples],
    }
    return batch


def batch_to_torch(batch: Dict, device="cuda") -> Dict:
    """Move the numpy leaves of a collated batch onto ``device`` as tensors
    (dtypes kept: int32 ids and CSR pointers, bool masks, float32 values, as
    the segment kernels' wrapper takes them); the nesting of a crop-ladder
    batch (``mappings[level]["buckets"][b]``, the ``bucket_images`` list) is
    kept; ``meta`` and other non-array leaves stay as they are.  Traced:
    the ``to_device`` span, and the bytes a card receives in the
    ``h2d_bytes`` counter."""
    h2d = torch.device(device).type != "cpu" and trace.enabled()

    def move(node):
        if isinstance(node, dict):
            return {k: v if k == "meta" else move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        if isinstance(node, np.ndarray):
            if h2d:
                trace.count("h2d_bytes", node.nbytes)
            return torch.from_numpy(np.ascontiguousarray(node)).to(device)
        return node

    with trace.span("to_device"):
        return move(batch)
