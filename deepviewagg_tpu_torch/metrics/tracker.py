"""Segmentation trackers: per-stage metric accumulation.

The port of ``SegmentationTracker`` of ``deepviewagg_tpu/metrics/
tracker.py`` (the reference's metrics/base_tracker.py:19,
segmentation_tracker.py:12): loss averaging and acc / macc / miou from the
streaming confusion matrix.  Vote accumulation (``VoteAccumulator``) comes
with the eval CLI (ROADMAP A.2.1).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

from .confusion import ConfusionMatrix

__all__ = ["SegmentationTracker"]


class SegmentationTracker:
    """Streaming loss + confusion metrics for one stage (train/val/test)."""

    def __init__(self, num_classes: int, stage: str = "train"):
        self.num_classes = num_classes
        self.stage = stage
        self.reset()

    def reset(self):
        self.cm = ConfusionMatrix(self.num_classes)
        self._loss_sum = defaultdict(float)
        self._loss_n = 0

    def track(self, preds, labels, valid=None, losses: Optional[Dict] = None):
        self.cm.add(preds, labels, valid)
        if losses:
            for k, v in losses.items():
                self._loss_sum[k] += float(v)
            self._loss_n += 1

    def get_metrics(self) -> Dict[str, float]:
        s = self.stage
        out = {
            f"{s}_acc": 100 * self.cm.overall_accuracy(),
            f"{s}_macc": 100 * self.cm.mean_class_accuracy(),
            f"{s}_miou": 100 * self.cm.miou(),
        }
        for k, tot in self._loss_sum.items():
            out[f"{s}_{k}"] = tot / max(self._loss_n, 1)
        return out

    @staticmethod
    def metric_direction(name: str) -> str:
        """'max' or 'min' — drives best-checkpoint selection
        (segmentation_tracker.py:107)."""
        return "min" if "loss" in name else "max"
