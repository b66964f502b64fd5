"""Segmentation trackers: per-stage metric accumulation + full-res voting.

The port of ``deepviewagg_tpu/metrics/tracker.py`` (the reference's
metrics/base_tracker.py:19, segmentation_tracker.py:12, s3dis_tracker.py:16,
kitti360_tracker.py:26): loss averaging, acc / macc / miou from the
streaming confusion matrix, and, for eval, **vote accumulation** keyed by
original point ids with a full-resolution 1-NN remap.  Host numpy, as in the
JAX package (the same inputs give the same bytes); only the remap's kNN runs
in torch, on the device the caller names.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.knn import knn
from .confusion import ConfusionMatrix

__all__ = ["SegmentationTracker", "VoteAccumulator"]


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


class VoteAccumulator:
    """Per-cloud prediction votes keyed by original point id
    (s3dis_tracker.py:25-61; kitti360's tempdir variant is the out-of-core
    version layered on top).

    ``add(cloud, size, origin_ids, logits)`` accumulates;
    ``full_res_preds`` remaps votes to the raw cloud with 1-NN interpolation
    for unpredicted points (knn_interpolate(k=1), s3dis_tracker.py:94-120).

    Past ``ram_budget_bytes`` of live vote arrays, new clouds spill to
    memmap'd ``.npy`` files under a private temporary directory, the
    reference's KITTI-360 out-of-core per-window vote files
    (kitti360_tracker.py:110-154,340-368); it is removed with the object.
    """

    def __init__(self, num_classes: int,
                 ram_budget_bytes: Optional[int] = None):
        self.num_classes = num_classes
        self._votes: Dict[str, np.ndarray] = {}
        self._counts: Dict[str, np.ndarray] = {}
        self._ram_budget = ram_budget_bytes
        self._ram_bytes = 0
        self._tempdir = None
        self.spilled: int = 0   # diagnostic: clouds living on disk

    def _spill_dir(self) -> str:
        if self._tempdir is None:
            self._tempdir = tempfile.TemporaryDirectory(prefix="dva_votes_")
        return self._tempdir.name

    def _alloc(self, cloud: str, size: int):
        nbytes = size * (4 * self.num_classes + 4)
        if (self._ram_budget is not None
                and self._ram_bytes + nbytes > self._ram_budget):
            key = hashlib.sha1(cloud.encode()).hexdigest()[:16]
            d = self._spill_dir()
            self._votes[cloud] = np.lib.format.open_memmap(
                os.path.join(d, f"{key}_votes.npy"), mode="w+",
                dtype=np.float32, shape=(size, self.num_classes))
            self._counts[cloud] = np.lib.format.open_memmap(
                os.path.join(d, f"{key}_counts.npy"), mode="w+",
                dtype=np.int32, shape=(size,))
            self.spilled += 1
        else:
            self._votes[cloud] = np.zeros((size, self.num_classes),
                                          np.float32)
            self._counts[cloud] = np.zeros((size,), np.int32)
            self._ram_bytes += nbytes

    def add(self, cloud: str, size: int, origin_ids, logits):
        if cloud not in self._votes:
            self._alloc(cloud, size)
        ids = np.asarray(origin_ids)
        np.add.at(self._votes[cloud], ids, np.asarray(logits, np.float32))
        np.add.at(self._counts[cloud], ids, 1)

    def clouds(self):
        return list(self._votes)

    def votes(self, cloud: str):
        """(votes [size, num_classes] float32, counts [size] int32)."""
        return self._votes[cloud], self._counts[cloud]

    def preds(self, cloud: str):
        """(preds [size], predicted_mask [size]) at vote resolution."""
        votes = self._votes[cloud]
        counts = self._counts[cloud]
        return votes.argmax(axis=1), counts > 0

    def full_res_preds(self, cloud: str, vote_pos, raw_pos, device="cuda"):
        """1-NN remap of voted predictions onto the raw cloud; the kNN runs
        on ``device``."""
        preds, mask = self.preds(cloud)
        idx_pred = np.nonzero(mask)[0]
        if len(idx_pred) == 0:
            return np.zeros(len(raw_pos), np.int64)
        query = torch.as_tensor(np.asarray(raw_pos, np.float32), device=device)
        points = torch.as_tensor(
            np.asarray(vote_pos, np.float32)[idx_pred], device=device)
        _, nn_idx = knn(query, points, k=1)
        return preds[idx_pred[nn_idx[:, 0].cpu().numpy()]]
