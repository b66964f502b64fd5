"""Synthetic dataset: end-to-end data pipeline without downloads.

The port of ``deepviewagg_tpu/data/datasets/synthetic_ds.py``: N synthetic
rooms through the production preprocessing path (voxel grid, PCA features
with k = 30 passed to the mapping factory, cache serialization) served by
the standard ``SphereDataset`` / ``BatchLoader`` machinery — the dataset of
``conf/synthetic.yaml``.  Preprocessing (kNN, eigensolver, z-buffers) runs
on ``device``; the caches are the JAX package's ``.npz`` format.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ...ops import voxel as _voxel
from .. import synthetic
from ..geometric import pca_features
from ..mapping_factory import VisibilityParams, build_mappings
from .base import AreaCache, SphereDataset, save_area

__all__ = ["build_synthetic_cache", "make_synthetic_dataset", "NUM_CLASSES"]

NUM_CLASSES = 4


def build_synthetic_cache(
    root: str,
    n_areas: int = 2,
    density: float = 150.0,
    n_cameras: int = 3,
    image_size=(128, 64),
    voxel_size: float = 0.06,
    seed: int = 0,
    keep_raw: bool = False,
    device="cuda",
) -> list:
    """Preprocess + cache synthetic areas (on ``device``); returns the .npz
    paths.  An area whose file exists is not rebuilt."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for a in range(n_areas):
        path = os.path.join(root, f"area_{a}.npz")
        paths.append(path)
        if os.path.exists(path):
            continue
        scene = synthetic.make_scene(
            seed=seed + a, density=density, n_cameras=n_cameras,
            image_size=image_size,
        )
        g = _voxel.grid_sample(
            scene.pos, voxel_size, feats=scene.rgb, labels=scene.labels
        )
        geo = pca_features(g["pos"], k=min(30, len(g["pos"]) - 1),
                           device=device)
        mapping = build_mappings(
            g["pos"], scene.cameras,
            VisibilityParams(voxel=voxel_size, max_splat=5),
            geometric=geo, nn_idx=geo["nn_idx"], device=device,
        )
        imgs = synthetic.render_views(scene, mapping)
        payload = {
            "pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
            "normal": geo["normal"].cpu().numpy(),
            "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
            "mapping": mapping, "images": imgs,
        }
        if keep_raw:
            payload["raw_pos"] = scene.pos
            payload["raw_labels"] = scene.labels
        save_area(path, payload)
    return paths


def make_synthetic_dataset(
    root: str, train: bool = True, n_areas: int = 2, radius: float = 2.0,
    voxel_size: float = 0.08, image_slots: int = 2,
    samples_per_epoch: int = 16, augment=None,
    mapping_params: Optional[dict] = None, aug_params: Optional[dict] = None,
    device="cuda", **cache_kw,
) -> SphereDataset:
    """``mapping_params`` / ``aug_params``: reference data-YAML
    transform-chain parameters, as in the JAX package (``data.ref`` ingest
    itself is not ported).  The cache is built on ``device``."""
    from .base import build_augment, dataset_aug_kwargs

    mp = dict(mapping_params or {})
    for drop in ("crop_padding", "proj_upscale", "density", "occlusion",
                 "r_max", "r_min", "k_swell", "exact", "n_sample", "nbf_k"):
        mp.pop(drop, None)
    cache_kw.update(mp)
    cache_kw.pop("fold", None)
    cache_kw.pop("frame_step", None)
    paths = build_synthetic_cache(root, n_areas=n_areas, device=device,
                                  **cache_kw)
    return SphereDataset(
        areas=AreaCache(paths, max_loaded=n_areas),
        radius=radius, voxel_size=voxel_size, num_classes=NUM_CLASSES,
        train=train,
        augment=augment if augment is not None else (
            build_augment(aug_params, None) if train else None),
        image_slots=image_slots,
        samples_per_epoch=samples_per_epoch,
        **dataset_aug_kwargs(aug_params, train),
    )
