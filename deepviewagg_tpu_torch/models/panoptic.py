"""Panoptic segmentation: semantic head + instance offsets + clustering.

The port of ``deepviewagg_tpu/models/panoptic.py`` (the reference's
panoptic task stack, datasets/panoptic + PointGroup-style models):
alongside the semantic logits, every point regresses an offset to its
instance centre; instances are recovered by clustering the shifted points
(host-side connected components over a voxel grid, deterministic).
:func:`panoptic_quality` and :func:`cluster_instances` are host numpy,
copied from the JAX package as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn.res16unet import RES16_PRESETS, Res16UNet

__all__ = ["PanopticSeg", "instance_loss", "cluster_instances",
           "panoptic_quality"]


class PanopticSeg(nn.Module):
    """Sparse UNet with two heads: semantics + instance centre offsets (the
    flax names ``backbone``, ``sem_head``, ``offset_head``).
    ``forward(batch)`` returns ``{"logits", "offsets"}``."""

    def __init__(self, num_classes: int, backbone: str = "Res16UNet14",
                 max_offset: float = 2.0, in_channels: int = 4,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.max_offset = max_offset
        self.backbone = Res16UNet(in_channels, *RES16_PRESETS[backbone],
                                  device=device)
        c = self.backbone.out_channels
        self.sem_head = nn.Linear(c, num_classes, device=device)
        self.offset_head = nn.Linear(c, 3, device=device)
        if seed is not None:
            from .segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        x = self.backbone(batch["feats"], batch["graph"])
        offsets = torch.tanh(self.offset_head(x)) * self.max_offset
        return {"logits": self.sem_head(x), "offsets": offsets}


def instance_loss(offsets, pos, instance_ids,
                  num_instances: Optional[int] = None, valid=None):
    """L1 between predicted offsets and (instance centroid - point), the
    PointGroup offset loss.  ``instance_ids`` integer, -1 = stuff / ignore.

    ``num_instances`` sizes the centroid table; it defaults to
    ``max(ids) + 1`` (a host read).  The ids are not sorted, so the
    centroids are ``index_add_`` sums, not sorted-segment reductions; no
    gradient flows through them (``pos`` is data)."""
    ids = torch.as_tensor(instance_ids, device=offsets.device)
    mask = ids >= 0
    if valid is not None:
        mask = mask & valid
    if num_instances is None:
        num_instances = int(ids.max()) + 1 if ids.numel() else 0
    if num_instances <= 0:
        return offsets.new_zeros(())
    safe = torch.clamp(ids, min=0).to(torch.int64)
    w = mask.to(torch.float32)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=offsets.device)
    # ids past the table drop out of the sums and read its last row, as
    # jax.ops.segment_sum drops them and a JAX gather clamps
    inside = safe < num_instances
    into = torch.where(inside, safe, 0)
    w_in = torch.where(inside, w, 0.0)
    cent_sum = pos.new_zeros((num_instances, 3)).index_add_(
        0, into, pos * w_in[:, None])
    cent_cnt = pos.new_zeros((num_instances,)).index_add_(0, into, w_in)
    centroids = cent_sum / torch.clamp(cent_cnt[:, None], min=1.0)
    target = centroids.index_select(
        0, torch.clamp(safe, max=num_instances - 1)) - pos
    l1 = torch.abs(offsets - target).sum(dim=1)
    return torch.sum(torch.where(mask, l1, 0.0)) / torch.clamp(mask.sum(),
                                                               min=1)


def panoptic_quality(pred_sem, pred_inst, gt_sem, gt_inst, num_classes: int,
                     thing_classes, iou_thresh: float = 0.5) -> Dict:
    """Panoptic Quality (Kirillov et al.): PQ = SQ x RQ per class, averaged.

    Things match instance-to-instance at point-IoU >= ``iou_thresh``; stuff
    classes match as single segments.  Host-side numpy evaluation.
    """
    pred_sem = np.asarray(pred_sem)
    gt_sem = np.asarray(gt_sem)
    pred_inst = np.asarray(pred_inst)
    gt_inst = np.asarray(gt_inst)
    pqs = []
    per_class = {}
    for c in range(num_classes):
        if c in thing_classes:
            p_ids = [i for i in np.unique(pred_inst[(pred_sem == c)]) if i >= 0]
            g_ids = [i for i in np.unique(gt_inst[(gt_sem == c)]) if i >= 0]
            p_masks = [(pred_inst == i) & (pred_sem == c) for i in p_ids]
            g_masks = [(gt_inst == i) & (gt_sem == c) for i in g_ids]
        else:
            p_masks = [pred_sem == c] if (pred_sem == c).any() else []
            g_masks = [gt_sem == c] if (gt_sem == c).any() else []
        if not g_masks and not p_masks:
            continue
        matched_p = set()
        tp, iou_sum = 0, 0.0
        for gm in g_masks:
            best_iou, best_j = 0.0, -1
            for j, pm in enumerate(p_masks):
                if j in matched_p:
                    continue
                inter = np.logical_and(gm, pm).sum()
                union = np.logical_or(gm, pm).sum()
                iou = inter / union if union else 0.0
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= iou_thresh:
                tp += 1
                iou_sum += best_iou
                matched_p.add(best_j)
        fn = len(g_masks) - tp
        fp = len(p_masks) - tp
        denom = tp + 0.5 * fp + 0.5 * fn
        pq = iou_sum / denom if denom else 0.0
        per_class[f"PQ_{c}"] = float(pq)
        pqs.append(pq)
    out = {"PQ": float(np.mean(pqs)) if pqs else 0.0}
    out.update(per_class)
    return out


def cluster_instances(pos, offsets, sem_preds, thing_classes,
                      cell: float = 0.3, min_points: int = 10):
    """Host-side clustering of center-shifted points into instance ids.

    Shifted points of 'thing' classes are voxelized at ``cell``; connected
    voxels (26-neighborhood within the same semantic class) form instances.
    Returns int32 instance ids (-1 for stuff / tiny clusters).
    """
    pos = np.asarray(pos)
    shifted = pos + np.asarray(offsets)
    sem = np.asarray(sem_preds)
    out = np.full(len(pos), -1, np.int32)
    next_id = 0
    for cls in thing_classes:
        sel = np.nonzero(sem == cls)[0]
        if len(sel) == 0:
            continue
        cells = np.floor(shifted[sel] / cell).astype(np.int64)
        # union-find over points sharing or adjacent in cell space
        key = {}
        parent = np.arange(len(sel))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for li, c in enumerate(map(tuple, cells)):
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        nb = (c[0] + dx, c[1] + dy, c[2] + dz)
                        if nb in key:
                            ra, rb = find(li), find(key[nb])
                            if ra != rb:
                                parent[ra] = rb
            key[c] = li
        roots = np.array([find(i) for i in range(len(sel))])
        for r in np.unique(roots):
            members = sel[roots == r]
            if len(members) >= min_points:
                out[members] = next_id
                next_id += 1
    return out
