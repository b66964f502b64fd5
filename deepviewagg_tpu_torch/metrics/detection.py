"""Detection metrics: axis-aligned 3D IoU and mean Average Precision.

The port of ``deepviewagg_tpu/metrics/detection.py``, a copy of its numpy
(the same results bit for bit): completes the VoteNet task stack (the
reference's object-detection trackers) with greedy confidence-ordered
matching of predicted boxes to ground truth at an IoU threshold, 11-point
interpolated AP per class, mAP@{0.25, 0.5}.  Host-side numpy
(evaluation-time).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["box_iou_3d", "average_precision", "mean_average_precision"]


def box_iou_3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between axis-aligned boxes ``[N, 6]`` x ``[M, 6]``
    (center xyz + size whd) -> ``[N, M]``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a_lo, a_hi = a[:, :3] - a[:, 3:] / 2, a[:, :3] + a[:, 3:] / 2
    b_lo, b_hi = b[:, :3] - b[:, 3:] / 2, b[:, :3] + b[:, 3:] / 2
    lo = np.maximum(a_lo[:, None], b_lo[None])
    hi = np.minimum(a_hi[:, None], b_hi[None])
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
    va = np.prod(np.maximum(a_hi - a_lo, 0.0), axis=-1)
    vb = np.prod(np.maximum(b_hi - b_lo, 0.0), axis=-1)
    union = va[:, None] + vb[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(
    pred_boxes: np.ndarray, pred_scores: np.ndarray, gt_boxes: np.ndarray,
    iou_thresh: float = 0.25,
) -> float:
    """11-point interpolated AP for one class, one scene collection.

    Greedy matching in descending score order; each GT matches at most one
    prediction.
    """
    if len(gt_boxes) == 0:
        return 0.0 if len(pred_boxes) else 1.0
    if len(pred_boxes) == 0:
        return 0.0
    order = np.argsort(-np.asarray(pred_scores))
    iou = box_iou_3d(np.asarray(pred_boxes)[order], gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(order))
    for i in range(len(order)):
        # VoteNet/PASCAL protocol: match the best-overlapping GT by RAW IoU;
        # if that GT is already taken the prediction is a duplicate -> FP
        # (matching the best UNtaken GT would convert protocol-FPs to TPs)
        j = int(np.argmax(iou[i]))
        if iou[i, j] >= iou_thresh and not taken[j]:
            taken[j] = True
            tp[i] = 1
    cum_tp = np.cumsum(tp)
    recall = cum_tp / len(gt_boxes)
    precision = cum_tp / (np.arange(len(order)) + 1)
    ap = 0.0
    for r in np.linspace(0, 1, 11):
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / 11
    return float(ap)


def mean_average_precision(
    predictions: Sequence[Dict], ground_truths: Sequence[Dict],
    num_classes: int, iou_thresh: float = 0.25,
) -> Dict[str, float]:
    """Per-scene prediction/GT dicts -> {'mAP', 'AP_<c>'} at ``iou_thresh``.

    Each prediction dict: {'boxes' [N,6], 'scores' [N], 'classes' [N]};
    each GT dict: {'boxes' [M,6], 'classes' [M]}.  Scenes are pooled per
    class (the standard benchmark protocol).
    """
    out = {}
    aps = []
    for c in range(num_classes):
        pb, ps, gb = [], [], []
        offset = 0.0
        for pred, gt in zip(predictions, ground_truths):
            sel_p = np.asarray(pred["classes"]) == c
            sel_g = np.asarray(gt["classes"]) == c
            # displace scenes far apart so cross-scene boxes never overlap
            shift = np.array([offset, 0, 0, 0, 0, 0])
            pb.append(np.asarray(pred["boxes"])[sel_p] + shift[:6])
            ps.append(np.asarray(pred["scores"])[sel_p])
            gb.append(np.asarray(gt["boxes"])[sel_g] + shift[:6])
            offset += 1e4
        pb = np.concatenate(pb) if pb else np.zeros((0, 6))
        ps = np.concatenate(ps) if ps else np.zeros(0)
        gb = np.concatenate(gb) if gb else np.zeros((0, 6))
        ap = average_precision(pb, ps, gb, iou_thresh)
        out[f"AP_{c}"] = ap
        if len(gb):
            aps.append(ap)
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    return out
