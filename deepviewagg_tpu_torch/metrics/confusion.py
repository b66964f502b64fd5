"""Streaming confusion matrix + IoU metrics.

The port of ``deepviewagg_tpu/metrics/confusion.py`` (the reference's
``ConfusionMatrix``, metrics/confusion_matrix.py:6-99): bincount
accumulation in numpy on the host, overall / mean accuracy, per-class IoU
with a missing-class mask.  It is fed by one device-to-host copy of the
predictions per tracked step.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConfusionMatrix"]


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.m = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self.m[:] = 0

    def add(self, preds, labels, valid=None):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        mask = labels >= 0
        if valid is not None:
            mask = mask & np.asarray(valid).reshape(-1)
        p, l = preds[mask], labels[mask]
        self.m += np.bincount(
            l * self.num_classes + p, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    def add_matrix(self, m):
        self.m += np.asarray(m, np.int64)

    @property
    def count(self):
        return int(self.m.sum())

    def overall_accuracy(self) -> float:
        t = self.m.sum()
        return float(np.diag(self.m).sum() / t) if t else 0.0

    def per_class_iou(self):
        """(iou [C], present [C]) — classes absent from both gt and pred are
        masked out of the mean (confusion_matrix.py:60-80)."""
        tp = np.diag(self.m).astype(np.float64)
        fp = self.m.sum(axis=0) - tp
        fn = self.m.sum(axis=1) - tp
        union = tp + fp + fn
        present = union > 0
        iou = np.where(present, tp / np.maximum(union, 1), 0.0)
        return iou, present

    def miou(self) -> float:
        iou, present = self.per_class_iou()
        return float(iou[present].mean()) if present.any() else 0.0

    def mean_class_accuracy(self) -> float:
        tp = np.diag(self.m).astype(np.float64)
        gt = self.m.sum(axis=1)
        present = gt > 0
        acc = np.where(present, tp / np.maximum(gt, 1), 0.0)
        return float(acc[present].mean()) if present.any() else 0.0
