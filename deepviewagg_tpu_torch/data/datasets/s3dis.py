"""S3DIS fused-area multimodal dataset.

The port of ``deepviewagg_tpu/data/datasets/s3dis.py`` (the reference's
``S3DISOriginalFusedMM`` / ``S3DISSphereMM`` pipeline,
datasets/segmentation/multimodal/s3dis.py:131,622): six building areas, each
fused from per-room annotation txt files; equirectangular panoramas with
omega/phi/kappa pose JSONs (``read_s3dis_pose``, s3dis.py:76); the
preprocess voxelizes at 5 cm, computes PCA features and exact
splat-visibility mappings per area, drops the mappings of static pixels and
caches the area in the JAX package's ``.npz`` format; training samples 2 m
class-balanced spheres.  The voxel grid and the txt reads are host numpy,
the kNN, PCA and z-buffers run on ``device``, and the panoramas are read
by :mod:`deepviewagg_tpu_torch.utils.image_io` (no PIL).

Raw layout (the public 2D-3D-S release):
  <root>/Area_<k>/<room>/Annotations/<class>_<i>.txt   (x y z r g b rows)
  <root>/Area_<k>/data/pose/*_pose.json    {"camera_location": [...],
                                            "final_camera_rotation": [o,p,k]}
  <root>/Area_<k>/data/rgb/<name>.png      equirectangular panoramas
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np

from ...core.cameras import Camera
from ...ops import voxel as _voxel
from ...utils.image_io import load_image
from ..geometric import pca_features
from ..mapping_factory import VisibilityParams, build_mappings
from ..transforms2d import (mask_mapping_pixels, non_static_mask,
                            select_images_by_coverage)
from ..transforms3d import (Compose, RandomNoise, RandomRotate,
                            RandomScaleAnisotropic, RandomSymmetry)
from .base import (AreaCache, SphereDataset, build_augment,
                   dataset_aug_kwargs, save_area)

__all__ = ["S3DIS_CLASSES", "make_s3dis_dataset", "preprocess_s3dis_area",
           "read_s3dis_pose", "load_s3dis_room", "area_cameras",
           "default_augment"]

S3DIS_CLASSES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "chair", "table", "bookcase", "sofa", "board", "clutter",
)
_CLASS_TO_ID = {c: i for i, c in enumerate(S3DIS_CLASSES)}
NUM_CLASSES = len(S3DIS_CLASSES)
FOLDS = {k: [k] for k in range(1, 7)}   # test area per fold

# S3DIS equirectangular capture settings (reference
# conf/data/segmentation/multimodal/s3disfused-sparse.yaml)
IMG_SIZE = (2048, 1024)
R_MIN, R_MAX = 0.5, 8.0


def read_s3dis_pose(path: str):
    """Pose JSON -> (position [3], omega/phi/kappa [3])
    (reference ``read_s3dis_pose``, s3dis.py:76-100)."""
    with open(path) as f:
        meta = json.load(f)
    pos = np.asarray(meta["camera_location"], np.float32)
    opk = np.asarray(meta["final_camera_rotation"], np.float32)
    return pos, opk


def load_s3dis_room(room_dir: str):
    """Fuse a room's annotation txt files -> (pos, rgb, labels); unknown
    class names are clutter."""
    pts, cols, labels = [], [], []
    for f in sorted(glob.glob(os.path.join(room_dir, "Annotations", "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        label = _CLASS_TO_ID.get(cls, _CLASS_TO_ID["clutter"])
        data = np.loadtxt(f, dtype=np.float32)
        if data.ndim == 1:
            data = data[None]
        pts.append(data[:, :3])
        cols.append(data[:, 3:6] / 255.0)
        labels.append(np.full(len(data), label, np.int32))
    if not pts:
        raise FileNotFoundError(f"no annotations under {room_dir}")
    return (np.concatenate(pts), np.concatenate(cols).astype(np.float32),
            np.concatenate(labels))


def area_cameras(area_dir: str, image_size=IMG_SIZE,
                 r_min: float = R_MIN, r_max: float = R_MAX) -> List[dict]:
    """All posed panoramas of an area: list of {path, camera}."""
    out = []
    for pose_path in sorted(
        glob.glob(os.path.join(area_dir, "data", "pose", "*_pose.json"))
    ):
        pos, opk = read_s3dis_pose(pose_path)
        rgb = pose_path.replace("/pose/", "/rgb/").replace(
            "_pose.json", "_rgb.png"
        )
        if not os.path.exists(rgb):
            continue
        out.append({
            "path": rgb,
            "camera": Camera(
                model="s3dis_equirectangular", size=tuple(image_size),
                pos=pos, opk=opk, r_min=r_min, r_max=r_max,
            ),
        })
    return out


def _apply_non_static_mask(mapping, images, n_sample: int = 5):
    """Invalidate mapping pixels on static (identical-across-images) pixels
    — the capture rig in panoramas (ref NonStaticMask in every flagship
    recipe's pre_transform, image.py:106-158, baked into projection there;
    applied to the computed mapping here — same pixels dropped)."""
    if len(images) < 2:
        return mapping
    mask = non_static_mask(images, n_sample=n_sample)
    if mask.all():
        return mapping
    return mask_mapping_pixels({"mapping": mapping}, mask)["mapping"]


def preprocess_s3dis_area(
    root: str, area: int, out_dir: str,
    voxel_size: float = 0.05,
    image_size=(1024, 512),
    max_images: Optional[int] = None,
    exact_splatting: bool = True,
    keep_raw: bool = False,
    r_max: float = R_MAX, r_min: float = R_MIN,
    k_swell: float = 1.0, n_sample: int = 5, nbf_k: int = 50,
    device="cuda",
) -> str:
    """One-time preprocess of one area -> cache .npz (SURVEY.md §3.4); an
    area whose cache exists is not rebuilt.

    The reference's pre_collate chain: fuse rooms -> voxelize -> PCA eigen
    features -> per-image splat visibility (exact_splatting_2d for S3DIS,
    §A.2) -> mapping arrays + density/occlusion; kNN, PCA and z-buffers on
    ``device``.
    """
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"area_{area}.npz")
    if os.path.exists(out_path):
        return out_path
    area_dir = os.path.join(root, f"Area_{area}")
    rooms = sorted(
        d for d in glob.glob(os.path.join(area_dir, "*"))
        if os.path.isdir(os.path.join(d, "Annotations"))
    )
    if not rooms:
        raise FileNotFoundError(f"no rooms under {area_dir}")
    pts, cols, labs = [], [], []
    for r in rooms:
        p, c, l = load_s3dis_room(r)
        pts.append(p)
        cols.append(c)
        labs.append(l)
    pos = np.concatenate(pts)
    rgb = np.concatenate(cols)
    labels = np.concatenate(labs)

    g = _voxel.grid_sample(pos, voxel_size, feats=rgb, labels=labels)
    geo = pca_features(g["pos"], k=nbf_k, device=device)

    cams_meta = area_cameras(area_dir, image_size, r_min=r_min, r_max=r_max)
    cams = [c["camera"] for c in cams_meta]
    # mappings are built for EVERY camera; max_images then keeps a greedy
    # max-coverage subset (the reference selects by mapping area / pixel
    # credit at preprocess time, data_transform/multimodal/image.py:713,765)
    mapping = build_mappings(
        g["pos"], cams,
        VisibilityParams(voxel=voxel_size, exact=exact_splatting,
                         k_swell=k_swell, d_swell=1000.0),
        geometric=geo, nn_idx=geo["nn_idx"], device=device,
    )
    if max_images and mapping.num_images > max_images:
        keep = select_images_by_coverage(mapping, max_images)
        mapping = mapping.select_images(keep).compact()
        cams_meta = [cams_meta[i] for i in keep]
    # only the selected images are ever read from disk, as uint8
    images = np.stack([load_image(c["path"], image_size) for c in cams_meta])
    mapping = _apply_non_static_mask(mapping, images, n_sample=n_sample)
    payload = {
        "pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
        "normal": geo["normal"].cpu().numpy(),
        "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
        "mapping": mapping, "images": images,
    }
    if keep_raw:
        # raw (pre-voxelization) cloud for full-resolution vote remap
        # (s3dis_tracker.py:94-120)
        payload["raw_pos"] = pos.astype(np.float32)
        payload["raw_labels"] = labels.astype(np.int32)
    save_area(out_path, payload)
    return out_path


def default_augment() -> Compose:
    """The S3DIS train augmentation chain
    (conf/data/segmentation/multimodal/s3disfused-sparse.yaml train_transform)."""
    return Compose([
        RandomNoise(sigma=0.001),
        RandomRotate(axis="z"),
        RandomScaleAnisotropic(0.8, 1.2),
        # s3disfused-sparse.yaml:57-59: x-axis mirror
        RandomSymmetry(axes=(True, False, False)),
    ])


def make_s3dis_dataset(
    root: str, train: bool = True, fold: int = 5, radius: float = 2.0,
    voxel_size: float = 0.05, image_slots: int = 4,
    samples_per_epoch: int = 2000, cache_dir: Optional[str] = None,
    mapping_params: Optional[dict] = None, aug_params: Optional[dict] = None,
    device="cuda", **preprocess_kw,
) -> SphereDataset:
    """Train on all areas except ``fold``; eval on area ``fold``
    (the 6-fold protocol, scripts/train_s3dis.sh); caches under
    ``<root>/processed_dva`` unless ``cache_dir``, built on ``device``.

    ``mapping_params`` / ``aug_params`` carry the reference data YAML's
    transform-chain parameterization, as in the JAX package: MapImages
    r_max/r_min/k_swell/exact, NonStaticMask n_sample,
    NeighborhoodBasedMappingFeatures k at preprocess time; jitter/color/
    flip/roll/credit knobs at runtime."""
    cache_dir = cache_dir or os.path.join(root, "processed_dva")
    mp = dict(mapping_params or {})
    mp.pop("crop_padding", None)   # consumed by the collate crop ladder
    mp.pop("proj_upscale", None)   # z-buffers at native resolution
    mp.pop("density", None), mp.pop("occlusion", None)  # always computed
    if "exact" in mp:
        preprocess_kw.setdefault("exact_splatting", mp.pop("exact"))
    preprocess_kw.update(mp)
    ds_kw = dataset_aug_kwargs(aug_params, train)
    areas = [
        a for a in range(1, 7)
        if (a != fold) == train
        and os.path.isdir(os.path.join(root, f"Area_{a}"))
    ]
    if not areas:
        raise FileNotFoundError(
            f"no S3DIS areas for {'train' if train else 'eval'} fold {fold} "
            f"under {root}"
        )
    paths = [
        preprocess_s3dis_area(root, a, cache_dir, voxel_size=voxel_size,
                              device=device, **preprocess_kw)
        for a in areas
    ]
    return SphereDataset(
        areas=AreaCache(paths, max_loaded=2),
        radius=radius, voxel_size=voxel_size, num_classes=NUM_CLASSES,
        train=train,
        augment=build_augment(aug_params,
                              default_augment()) if train else None,
        image_slots=image_slots, samples_per_epoch=samples_per_epoch,
        **{
            # the published recipe's defaults (s3disfused-sparse.yaml:
            # 144-170), overridden by ingested aug_params
            "center_roll": True,        # equirectangular panoramas (§A.7)
            "flip_p": 0.5 if train else 0.0,
            "jitter_mapping": 0.02 if train else 0.0,
            "color_jitter": (0.6, 0.6, 0.7) if train else None,
            **ds_kw,
        },
    )
