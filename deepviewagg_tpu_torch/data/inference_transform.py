"""Run a trained model as a data transform (feature extraction).

The port of ``deepviewagg_tpu/data/inference_transform.py`` (the
reference's ``ModelInference`` / ``PointNetForward``,
core/data_transform/inference_transforms.py:11-86): load a checkpointed
model from its run dir (the stored ``run.json`` is the source of truth, like
``ModelCheckpoint.create_model``) and attach its per-point output to the
cloud under ``feat_name``, e.g. to feed a second-stage model with
pretrained features.

Restricted to 3D-only backbones (the reference's only concrete subclass is
a PointNet forward).  The model is built on ``device`` and its parameters
are restored once; the JAX version's cache of compiled programs per
capacity bucket has no counterpart (torch compiles nothing per shape).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..config.run import load_run_config
from ..config.zoo import resolve_spec_from_cfg
from ..models.segmentation import build_model
from ..ops import voxel as _voxel
from ..train.checkpoint import CheckpointManager
from .collate import Bucket, Sample, batch_to_torch, collate, device_view
from .transforms3d import quantize_cloud

__all__ = ["ModelInference"]


def _round_pow2(n: int, minimum: int = 256) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


class ModelInference:
    """Attach a trained model's logits (or probabilities, or labels) per
    voxel.

    Parameters mirror the reference: ``run_dir`` holding ``run.json`` +
    checkpoints, ``weight`` selecting ``latest`` / ``best_<metric>``,
    ``feat_name`` the output key, ``output`` one of ``"logits"`` /
    ``"probs"`` / ``"labels"``; ``device`` where the model runs.
    """

    def __init__(self, run_dir: str, feat_name: str = "model_feat",
                 weight: str = "latest", output: str = "logits",
                 device="cuda"):
        run_json = os.path.join(run_dir, "run.json")
        if not os.path.exists(run_json):
            raise FileNotFoundError(f"no run.json under {run_dir}")
        with open(run_json) as f:
            stored = json.load(f)
        self.cfg = load_run_config(None, [], base=stored)
        spec = resolve_spec_from_cfg(self.cfg.model, self.cfg.data.num_classes)
        if spec.branches:
            raise ValueError(
                "ModelInference supports 3D-only checkpoints (the reference's "
                "concrete subclass is a plain PointNet forward too)"
            )
        if spec.in_channels != 4:
            raise ValueError(
                f"checkpoint expects in_channels={spec.in_channels}; "
                "ModelInference builds the standard rgb+ones (4-channel) "
                "features only"
            )
        self.spec = spec
        self.device = torch.device(device)
        # params-only restore: the stored optimizer state depends on training
        # settings this transform neither knows nor needs
        self.model = CheckpointManager(run_dir).restore_variables(
            weight, build_model(spec, device=self.device, seed=None)).eval()
        self.feat_name = feat_name
        self.output = output

    def __call__(self, cloud: dict, rng: Optional[np.random.Generator] = None):
        q = cloud if "coords" in cloud else quantize_cloud(
            cloud, self.cfg.data.voxel_size
        )
        n = len(q["coords"])
        rgb = q.get("rgb")
        if rgb is None:
            rgb = np.zeros((n, 3), np.float32)
        feats = np.concatenate(
            [np.asarray(rgb, np.float32), np.ones((n, 1), np.float32)], axis=1
        )
        caps = [_round_pow2(n)]
        cur = np.concatenate(
            [np.zeros((n, 1), np.int32), np.asarray(q["coords"], np.int32)],
            axis=1,
        )
        stride = 1
        for _ in range(4):
            cur, _ = _voxel.downsample_coords(cur, stride * 2)
            stride *= 2
            caps.append(_round_pow2(len(cur)))
        bucket = Bucket(level_caps=caps, num_batches=1)
        sample = Sample(coords=np.asarray(q["coords"], np.int32), feats=feats,
                        labels=np.zeros(n, np.int32))
        batch = batch_to_torch(device_view(collate(
            [sample], bucket, conv0_kernel=self.spec.stem_kernel)),
            self.device)
        with torch.no_grad():
            logits = self.model(batch)["logits"][:n].cpu().numpy()

        out = dict(q)
        if self.output == "labels":
            out[self.feat_name] = logits.argmax(1).astype(np.int32)
        elif self.output == "probs":
            e = np.exp(logits - logits.max(1, keepdims=True))
            out[self.feat_name] = (e / e.sum(1, keepdims=True)).astype(np.float32)
        else:
            out[self.feat_name] = logits.astype(np.float32)
        return out
