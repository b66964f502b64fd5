"""ScanNet multimodal dataset (per-scan rooms + .sens-exported frames).

The port of ``deepviewagg_tpu/data/datasets/scannet.py`` (the reference's
``ScannetMM``, datasets/segmentation/multimodal/scannet.py): per-scan meshes
``<scan>_vh_clean_2.ply`` with NYU40 vertex labels remapped to the 20-class
benchmark subset; 2D frames exported from the ``.sens`` stream as
``color/<i>.jpg`` + ``pose/<i>.txt`` (4x4 camera-to-world: the ``scannet``
camera model inverts it) + ``intrinsic/intrinsic_color.txt``.  The voxel
grid and the PLY / txt reads are host numpy, the kNN, PCA and z-buffers run
on ``device``, and the frames are read by
:mod:`deepviewagg_tpu_torch.utils.image_io` (baseline JPEG, no PIL).  The
caches are the JAX package's ``.npz`` format.

Raw layout (the public ScanNet v2 release, frames exported from ``.sens``):
  <root>/scans/scene<id>_<k>/<scan>_vh_clean_2.ply          (x y z r g b)
  <root>/scans/scene<id>_<k>/<scan>_vh_clean_2.labels.ply   (NYU40 label)
  <root>/scans/scene<id>_<k>/pose/<i>.txt, color/<i>.jpg,
                             intrinsic/intrinsic_color.txt
  <root>/scannetv2_{train,val}.txt                          (split lists)
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import List, Optional

import numpy as np

from ...core.cameras import Camera
from ...ops import voxel as _voxel
from ...utils.image_io import jpeg_size, load_image
from ...utils.ply import read_ply
from ..geometric import pca_features
from ..mapping_factory import VisibilityParams, build_mappings
from ..transforms2d import select_images_by_coverage
from .base import (AreaCache, SphereDataset, build_augment,
                   dataset_aug_kwargs, save_area)
from .s3dis import _apply_non_static_mask, default_augment

__all__ = ["SCANNET_CLASSES", "VALID_CLASS_IDS", "make_scannet_dataset",
           "preprocess_scannet_scan", "load_pose", "write_submission"]

SCANNET_CLASSES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)
# NYU40 ids of the benchmark classes (scannet.py VALID_CLASS_IDS)
VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                   33, 34, 36, 39)
NUM_CLASSES = len(SCANNET_CLASSES)
_NYU40_TO_TRAIN = np.full(41, -1, np.int32)
for _i, _cid in enumerate(VALID_CLASS_IDS):
    _NYU40_TO_TRAIN[_cid] = _i

IMG_SIZE = (640, 480)   # .sens color streams (reference exports 640x480)
R_MIN, R_MAX = 0.3, 6.0


def load_pose(path: str) -> np.ndarray:
    """4x4 camera-to-world matrix from a .sens-exported pose txt
    (scannet.py:21-30)."""
    return np.loadtxt(path, dtype=np.float32).reshape(4, 4)


def load_scan_cloud(scan_dir: str):
    """``(pos, rgb in [0, 1], train-id labels)`` of a scan's mesh vertices;
    -1 labels without a labels PLY and for NYU40 ids outside the
    benchmark."""
    scan = os.path.basename(scan_dir.rstrip("/"))
    mesh = read_ply(os.path.join(scan_dir, f"{scan}_vh_clean_2.ply"))
    pos = np.stack([mesh["x"], mesh["y"], mesh["z"]], 1).astype(np.float32)
    rgb = np.stack([mesh["red"], mesh["green"], mesh["blue"]], 1)
    rgb = rgb.astype(np.float32) / 255.0
    label_path = os.path.join(scan_dir, f"{scan}_vh_clean_2.labels.ply")
    if os.path.exists(label_path):
        lab = read_ply(label_path)["label"].astype(np.int64)
        labels = _NYU40_TO_TRAIN[np.clip(lab, 0, 40)]
    else:
        labels = np.full(len(pos), -1, np.int32)
    return pos, rgb, labels.astype(np.int32)


def scan_cameras(scan_dir: str, image_size=IMG_SIZE, frame_step: int = 20,
                 r_min: float = R_MIN, r_max: float = R_MAX) -> List[dict]:
    """Every ``frame_step``-th exported frame (the reference subsamples the
    video stream the same way), frames without a colour image or with a
    non-finite pose skipped.  The colour intrinsics are defined at the
    native export resolution, read from the first frame's JPEG header, and
    rescaled to ``image_size`` so that mappings stay aligned with the
    resized images."""
    intr_path = os.path.join(scan_dir, "intrinsic", "intrinsic_color.txt")
    k = (np.loadtxt(intr_path, dtype=np.float32).reshape(4, 4)
         if os.path.exists(intr_path) else None)
    out = []
    poses = sorted(
        glob.glob(os.path.join(scan_dir, "pose", "*.txt")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )
    if k is not None and poses:
        first_idx = os.path.splitext(os.path.basename(poses[0]))[0]
        first_img = os.path.join(scan_dir, "color", f"{first_idx}.jpg")
        if os.path.exists(first_img):
            native_w, native_h = jpeg_size(first_img)
            k = k.copy()
            k[0] *= image_size[0] / native_w
            k[1] *= image_size[1] / native_h
    for pose_path in poses[::frame_step]:
        idx = os.path.splitext(os.path.basename(pose_path))[0]
        color = os.path.join(scan_dir, "color", f"{idx}.jpg")
        if not os.path.exists(color):
            continue
        cam_to_world = load_pose(pose_path)
        if not np.isfinite(cam_to_world).all():
            continue
        # reference convention: the scannet extrinsic IS the cam->world pose
        # (multimodal/scannet.py:166,192); projection inverts internally
        out.append({
            "path": color,
            "camera": Camera(
                model="scannet", size=tuple(image_size),
                extrinsic=cam_to_world, intrinsic=k,
                r_min=r_min, r_max=r_max,
            ),
        })
    return out


def preprocess_scannet_scan(
    scan_dir: str, out_dir: str, voxel_size: float = 0.05,
    image_size=(320, 240), frame_step: int = 20,
    max_images: Optional[int] = 40,
    exact_splatting: bool = False,
    r_max: float = R_MAX, r_min: float = R_MIN,
    k_swell: float = 1.0, n_sample: int = 5, nbf_k: int = 50,
    device="cuda",
) -> str:
    """One-time preprocess of one scan -> cache ``<scan>.npz``; a scan
    whose cache exists is not rebuilt.  Voxel grid on the host; PCA, kNN,
    z-buffers and view features on ``device``; a greedy max-coverage
    subset of ``max_images`` frames, then only those are decoded."""
    os.makedirs(out_dir, exist_ok=True)
    scan = os.path.basename(scan_dir.rstrip("/"))
    out_path = os.path.join(out_dir, f"{scan}.npz")
    if os.path.exists(out_path):
        return out_path
    pos, rgb, labels = load_scan_cloud(scan_dir)

    g = _voxel.grid_sample(pos, voxel_size, feats=rgb, labels=labels)
    geo = pca_features(g["pos"], k=nbf_k, device=device)
    cams_meta = scan_cameras(scan_dir, image_size, frame_step,
                             r_min=r_min, r_max=r_max)
    cams = [c["camera"] for c in cams_meta]
    mapping = build_mappings(
        g["pos"], cams,
        VisibilityParams(voxel=voxel_size, exact=exact_splatting,
                         k_swell=k_swell),
        geometric=geo, nn_idx=geo["nn_idx"], device=device,
    )
    # greedy max-coverage selection over the full mapping, then load only
    # the kept frames as uint8 (see s3dis.preprocess_s3dis_area)
    if max_images and mapping.num_images > max_images:
        keep = select_images_by_coverage(mapping, max_images)
        mapping = mapping.select_images(keep).compact()
        cams_meta = [cams_meta[i] for i in keep]
    images = np.stack([load_image(c["path"], image_size) for c in cams_meta])
    mapping = _apply_non_static_mask(mapping, images, n_sample=n_sample)
    save_area(out_path, {
        "pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
        "normal": geo["normal"].cpu().numpy(),
        "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
        "mapping": mapping,
        "images": images,
    })
    return out_path


def write_submission(out_dir: str, scan_preds) -> str:
    """ScanNet benchmark submission: one ``<scan>.txt`` per scan with the
    per-vertex NYU40 id (train id -> VALID_CLASS_IDS remap,
    metrics/scannet_segmentation_tracker.py:77-86)."""
    os.makedirs(out_dir, exist_ok=True)
    ids = np.asarray(VALID_CLASS_IDS, np.int64)
    for scan, train_preds in scan_preds.items():
        mapped = ids[np.clip(train_preds, 0, NUM_CLASSES - 1)]
        np.savetxt(os.path.join(out_dir, f"{scan}.txt"), mapped, fmt="%d")
    return out_dir


def make_scannet_dataset(
    root: str, train: bool = True, voxel_size: float = 0.05,
    image_slots: int = 6, radius: float = 2.0,
    samples_per_epoch: int = 2000, cache_dir: Optional[str] = None,
    split_file: Optional[str] = None,
    mapping_params: Optional[dict] = None, aug_params: Optional[dict] = None,
    device="cuda", **preprocess_kw,
) -> SphereDataset:
    """``root`` holds ``scans/scene*``; splits follow the official
    scannetv2_{train,val}.txt lists when present, else a deterministic
    90/10 split (with a warning); caches under ``<root>/processed_dva``
    unless ``cache_dir``, built on ``device``.  ``mapping_params`` /
    ``aug_params``: the ingested reference data-YAML transform chain (see
    ``make_s3dis_dataset``)."""
    cache_dir = cache_dir or os.path.join(root, "processed_dva")
    mp = dict(mapping_params or {})
    for drop in ("crop_padding", "proj_upscale", "density", "occlusion"):
        mp.pop(drop, None)
    if "exact" in mp:
        preprocess_kw.setdefault("exact_splatting", mp.pop("exact"))
    preprocess_kw.update(mp)
    ds_kw = dataset_aug_kwargs(aug_params, train)
    scans = sorted(glob.glob(os.path.join(root, "scans", "scene*")))
    if split_file is None:
        name = "scannetv2_train.txt" if train else "scannetv2_val.txt"
        split_file = os.path.join(root, name)
    if os.path.exists(split_file):
        with open(split_file) as f:
            keep = {line.strip() for line in f if line.strip()}
        scans = [s for s in scans if os.path.basename(s) in keep]
    elif len(scans) > 1:
        # no official list: deterministic 90/10 split, never overlapping
        warnings.warn("ScanNet split lists not found; using a deterministic "
                      "90/10 scan split")
        split = [s for i, s in enumerate(scans) if (i % 10 != 0) == train]
        scans = split or scans   # tiny corpora: better overlapped than empty
    if not scans:
        raise FileNotFoundError(f"no scans under {root}/scans")
    paths = [
        preprocess_scannet_scan(s, cache_dir, voxel_size=voxel_size,
                                device=device, **preprocess_kw)
        for s in scans
    ]
    return SphereDataset(
        areas=AreaCache(paths, max_loaded=8),
        radius=radius, voxel_size=voxel_size, num_classes=NUM_CLASSES,
        train=train,
        augment=build_augment(aug_params,
                              default_augment()) if train else None,
        image_slots=image_slots, samples_per_epoch=samples_per_epoch,
        **{
            # scannet-sparse.yaml:156 radiometric augmentation
            "color_jitter": (0.6, 0.6, 0.7) if train else None,
            **ds_kw,
        },
    )
