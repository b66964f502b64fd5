"""KITTI-360 multimodal dataset: accumulated windows + cylinder sampling.

The port of ``deepviewagg_tpu/data/datasets/kitti360.py`` (the reference's
``KITTI360Cylinder`` / ``KITTI360CylinderMM``, datasets/segmentation/
kitti360.py:85-744, multimodal/kitti360.py:37-573): out-of-core *windows*
(accumulated static scans ``data_3d_semantics/<seq>/static/<start>_<end>.ply``)
served through an LRU buffer, 6 m vertical *cylinders* with class-balanced
random centres at train time; posed images from cam0 (rectified pinhole,
``cam0_to_world.txt`` + ``perspective.txt``) and cam2/cam3 (MEI fisheye,
``calib_cam_to_pose.txt`` + ``poses.txt`` + ``image_0{2,3}.yaml``).  Each
camera family keeps its own image size (pinhole ``image_size``, fisheye at its
native 1:1 ``fisheye_size``) and the batches carry one ladder bucket per
family.  The voxel grid and the PLY / txt / YAML reads are host numpy, the
kNN, PCA and z-buffers run on ``device``, and the PNG frames are read by
:mod:`deepviewagg_tpu_torch.utils.image_io` (no PIL).  The caches are the JAX
package's ``.npz`` format.

Label space: KITTI-360 ids -> 19 Cityscapes train ids (``ID2TRAINID``,
kitti360_config.py); submissions remap back (``TRAINID2ID``) into per-window
``{seq}_{start}_{end}.npy`` files zipped in the benchmark layout
(metrics/kitti360_tracker.py:259-297), one id per cached voxel: the cache
keeps no raw cloud.

Raw layout (the public KITTI-360 release):
  <root>/data_3d_semantics/<seq>/static/<start>_<end>.ply   (x y z red green
        blue semantic ...; instanceId, isVisible, confidence are skipped)
  <root>/data_3d_semantics[/train]/2013_05_28_drive_{train,val}.txt
  <root>/data_poses/<seq>/cam0_to_world.txt, poses.txt
  <root>/calibration/perspective.txt, calib_cam_to_pose.txt,
        image_02.yaml, image_03.yaml
  <root>/data_2d_raw/<seq>/image_00/data_rect/<frame:010d>.png
  <root>/data_2d_raw/<seq>/image_0{2,3}/data_rgb/<frame:010d>.png
"""

from __future__ import annotations

import glob
import os
import re
import warnings
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...config.yaml_subset import safe_load
from ...core.cameras import Camera
from ...ops import voxel as _voxel
from ...utils.image_io import load_image
from ...utils.ply import read_ply
from ..geometric import pca_features
from ..mapping_factory import VisibilityParams, build_mappings
from ..transforms2d import non_static_mask, select_images_by_coverage
from .base import (AreaCache, SphereDataset, build_augment,
                   dataset_aug_kwargs, save_area)
from .s3dis import default_augment

__all__ = ["KITTI360_CLASSES", "ID2TRAINID", "TRAINID2ID",
           "make_kitti360_dataset", "preprocess_kitti360_window",
           "read_cam0_to_world", "read_perspective_calib",
           "read_fisheye_calib", "read_cam_to_pose", "read_imu_poses",
           "write_submission"]

KITTI360_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)
NUM_CLASSES = len(KITTI360_CLASSES)

# KITTI-360 label ids -> train ids (kitti360scripts labels; the reference
# stores the same table in kitti360_config.py ID2TRAINID)
_ID_TRAIN_PAIRS = (
    (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7),
    (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14),
    (28, 15), (31, 16), (32, 17), (33, 18),
)
ID2TRAINID = np.full(256, -1, np.int32)
for _id, _t in _ID_TRAIN_PAIRS:
    ID2TRAINID[_id] = _t
TRAINID2ID = np.zeros(NUM_CLASSES, np.int32)
for _id, _t in _ID_TRAIN_PAIRS:
    TRAINID2ID[_t] = _id

PERSP_SIZE = (1408, 376)
FISHEYE_SIZE = (1400, 1400)
R_MIN, R_MAX = 1.0, 30.0

# the leading number of a token, as strtod reads it
_FLOAT_PREFIX = re.compile(
    r"[-+]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|inf(?:inity)?|nan)",
    re.IGNORECASE)


def _floats(text: str) -> np.ndarray:
    """float64 values of whitespace-separated numbers, read as
    ``np.fromstring(text, sep=" ")`` reads them: up to the first token that
    is not a whole number, of which the leading number (if any) is kept
    (``calib_time: 09-Jan-2012 14:00:15`` reads ``[9.]``).  Where numpy
    returns ``[-1.]`` (a value of whitespace only, or whose first token
    after leading whitespace holds no number), this returns no value; no
    line of the release's files has such a value."""
    out = []
    for tok in text.split():
        m = _FLOAT_PREFIX.match(tok)
        if m is not None:
            out.append(float(m.group(0)))
        if m is None or m.end() != len(tok):
            break
    return np.array(out, np.float64)


def read_cam0_to_world(path: str) -> Dict[int, np.ndarray]:
    """``cam0_to_world.txt`` rows: frame + 16 floats (4x4 cam->world)."""
    out = {}
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    for row in data:
        out[int(row[0])] = row[1:17].reshape(4, 4).astype(np.float32)
    return out


def read_perspective_calib(path: str) -> Dict[str, np.ndarray]:
    """``calibration/perspective.txt``: P_rect_00/01 3x4 + R_rect + sizes."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            out[key.strip()] = _floats(val)
    return out


def read_fisheye_calib(path: str) -> Optional[np.ndarray]:
    """``calibration/image_02.yaml`` (or _03) -> MEI intrinsics
    ``[xi, k1, k2, gamma1, gamma2, u0, v0]`` float32
    (multimodal/kitti360.py:120-188); ``None`` when the file or a key is
    missing.  The release's files open with a ``%YAML:1.0`` directive and
    a ``---`` document start: the directive is dropped (as the JAX package
    drops it before PyYAML reads the file) and so is the document start,
    which :func:`~deepviewagg_tpu_torch.config.yaml_subset.safe_load` does
    not read (PyYAML reads it as the start of the one document)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%")]
    first = next((i for i, l in enumerate(lines) if l.strip()), None)
    if first is not None and lines[first].rstrip() == "---":
        del lines[first]
    d = safe_load("\n".join(lines))
    try:
        mp = d["mirror_parameters"]
        dp = d["distortion_parameters"]
        pp = d["projection_parameters"]
        return np.array([
            mp["xi"], dp["k1"], dp["k2"],
            pp["gamma1"], pp["gamma2"], pp["u0"], pp["v0"],
        ], np.float32)
    except (KeyError, TypeError):
        return None


def read_cam_to_pose(path: str) -> dict:
    """``calibration/calib_cam_to_pose.txt``: per-camera 3x4 cam->IMU."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            m = _floats(val)
            if m.size == 12:
                e = np.eye(4)
                e[:3] = m.reshape(3, 4)
                out[key.strip()] = e.astype(np.float32)
    return out


def read_imu_poses(path: str) -> dict:
    """``data_poses/<seq>/poses.txt``: frame + 3x4 IMU->world."""
    out = {}
    if not os.path.exists(path):
        return out
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    for row in data:
        e = np.eye(4)
        e[:3] = row[1:13].reshape(3, 4)
        out[int(row[0])] = e.astype(np.float32)
    return out


def _in_window(frame: int, start: int, end: int, frame_step: int) -> bool:
    return start <= frame <= end and frame % frame_step == 0


def fisheye_cameras(root: str, seq: str, start: int, end: int,
                    image_size=FISHEYE_SIZE, frame_step: int = 10,
                    cam_ids=(2, 3), r_min: float = R_MIN,
                    r_max: float = R_MAX) -> List[dict]:
    """MEI fisheye cam2/cam3 of the window's frames: cam->world =
    IMU_pose @ cam_to_pose (multimodal/kitti360.py:120-188), the affine MEI
    part rescaled to ``image_size``; a camera without its YAML or its
    cam->IMU pose is skipped, as is a frame without its PNG."""
    cam_to_pose = read_cam_to_pose(
        os.path.join(root, "calibration", "calib_cam_to_pose.txt"))
    poses = read_imu_poses(os.path.join(root, "data_poses", seq, "poses.txt"))
    out = []
    for cam_id in cam_ids:
        fe = read_fisheye_calib(
            os.path.join(root, "calibration", f"image_0{cam_id}.yaml"))
        c2p = cam_to_pose.get(f"image_0{cam_id}")
        if fe is None or c2p is None:
            continue
        sx = image_size[0] / FISHEYE_SIZE[0]
        sy = image_size[1] / FISHEYE_SIZE[1]
        fe = fe * np.array([1, 1, 1, sx, sy, sx, sy], np.float32)
        for frame in sorted(poses):
            if not _in_window(frame, start, end, frame_step):
                continue
            img = os.path.join(root, "data_2d_raw", seq, f"image_0{cam_id}",
                               "data_rgb", f"{frame:010d}.png")
            if not os.path.exists(img):
                continue
            out.append({
                "path": img,
                "camera": Camera(
                    model="kitti360_fisheye", size=tuple(image_size),
                    extrinsic=poses[frame] @ c2p, fisheye=fe,
                    r_min=r_min, r_max=r_max,
                ),
            })
    return out


def _window_key(path: str) -> Tuple[str, int, int]:
    """``(sequence, start frame, end frame)`` of a window PLY's path."""
    seq = re.search(r"(2013_05_28_drive_\d+_sync)", path)
    m = re.search(r"(\d+)_(\d+)\.ply$", path)
    return (seq.group(1) if seq else "seq", int(m.group(1)), int(m.group(2)))


def load_window_cloud(path: str):
    """``(pos, rgb in [0, 1], train-id labels)`` of a window PLY; ``-1``
    labels without a ``semantic`` field and for ids outside the 19
    classes."""
    v = read_ply(path)
    pos = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    rgb = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    sem = v.get("semantic")
    labels = (ID2TRAINID[np.clip(sem.astype(np.int64), 0, 255)]
              if sem is not None else np.full(len(pos), -1, np.int32))
    return pos, rgb, labels.astype(np.int32)


def window_cameras(
    root: str, seq: str, start: int, end: int,
    image_size=None, frame_step: int = 10, cam_ids=(0,),
    r_min: float = R_MIN, r_max: float = R_MAX,
) -> List[dict]:
    """Rectified pinhole cameras (cam0 by default) of the window's frames,
    from ``cam0_to_world`` + ``P_rect`` rescaled to ``image_size``
    (multimodal/kitti360.py:37-120); a frame without its PNG is skipped."""
    pose_path = os.path.join(root, "data_poses", seq, "cam0_to_world.txt")
    calib = read_perspective_calib(
        os.path.join(root, "calibration", "perspective.txt"))
    if not os.path.exists(pose_path):
        return []
    poses = read_cam0_to_world(pose_path)
    out = []
    image_size = image_size or PERSP_SIZE
    for cam_id in cam_ids:
        p = calib.get(f"P_rect_0{cam_id}")
        if p is None:
            continue
        k = np.eye(4, dtype=np.float32)
        k[:3, :3] = p.reshape(3, 4)[:, :3].astype(np.float32)
        k[0] *= image_size[0] / PERSP_SIZE[0]
        k[1] *= image_size[1] / PERSP_SIZE[1]
        for frame in sorted(poses):
            if not _in_window(frame, start, end, frame_step):
                continue
            img = os.path.join(root, "data_2d_raw", seq, f"image_0{cam_id}",
                               "data_rect", f"{frame:010d}.png")
            if not os.path.exists(img):
                continue
            out.append({
                "path": img,
                "camera": Camera(
                    model="kitti360_perspective", size=tuple(image_size),
                    extrinsic=poses[frame], intrinsic=k,
                    r_min=r_min, r_max=r_max,
                ),
            })
    return out


def _family_non_static(mapping, images, families, n_sample: int = 5):
    """The non-static mask per camera family (the reference's NonStaticMask
    over same-setting images, image.py:106-158): masking across families
    would compare pinhole pixels against fisheye pixels."""
    keep = np.ones(mapping.pixel_capacity, bool)
    pv = np.minimum(mapping.pix_view, mapping.view_capacity - 1)
    pix_img = mapping.image_id[pv]
    for fam in np.unique(families):
        ids = np.nonzero(families == fam)[0]
        if len(ids) < 2:
            continue
        mask = non_static_mask(images[ids], n_sample=n_sample)
        if mask.all():
            continue
        static = ~mask[np.clip(mapping.pix_x, 0, mask.shape[0] - 1),
                       np.clip(mapping.pix_y, 0, mask.shape[1] - 1)]
        keep &= ~(np.isin(pix_img, ids) & static & mapping.pix_valid)
    return mapping.drop_pixels(keep)


def preprocess_kitti360_window(
    root: str, window_ply: str, out_dir: str, voxel_size: float = 0.05,
    image_size=(704, 188), fisheye_size=(350, 350), frame_step: int = 10,
    max_images: Optional[int] = 30,
    use_fisheye: bool = True,
    exact_splatting: bool = False,
    r_max: float = R_MAX, r_min: float = R_MIN,
    k_swell: float = 1.0, n_sample: int = 5, nbf_k: int = 50,
    device="cuda",
) -> str:
    """One-time preprocess of one window -> cache
    ``<seq>_<start>_<end>.npz`` (10-digit frames); a window whose cache
    exists is not rebuilt.

    Voxel grid on the host; PCA, kNN and z-buffers on ``device``; mappings
    for every camera of both families (cam0 pinhole at ``image_size``,
    family 0; cam2/cam3 fisheye at ``fisheye_size``, family 1, with
    ``use_fisheye``), then a greedy max-coverage subset of ``max_images``,
    and only those frames are decoded.  The images are stored as one uint8
    canvas of the largest family size, each frame at origin (0, 0), with
    ``image_family`` and ``family_sizes``; collate re-splits them per family
    through the ladder buckets."""
    os.makedirs(out_dir, exist_ok=True)
    seq, start, end = _window_key(window_ply)
    out_path = os.path.join(out_dir, f"{seq}_{start:010d}_{end:010d}.npz")
    if os.path.exists(out_path):
        return out_path
    pos, rgb, labels = load_window_cloud(window_ply)

    g = _voxel.grid_sample(pos, voxel_size, feats=rgb, labels=labels)
    geo = pca_features(g["pos"], k=nbf_k, device=device)
    cams_meta = window_cameras(root, seq, start, end, image_size, frame_step,
                               r_min=r_min, r_max=r_max)
    families = [0] * len(cams_meta)
    family_sizes = [tuple(image_size)]
    if use_fisheye:
        fmeta = fisheye_cameras(root, seq, start, end, fisheye_size,
                                frame_step, r_min=r_min, r_max=r_max)
        cams_meta += fmeta
        families += [1] * len(fmeta)
        family_sizes.append(tuple(fisheye_size))
    families = np.asarray(families, np.int64)
    mapping = build_mappings(
        g["pos"], [c["camera"] for c in cams_meta],
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
        families = families[keep]
    canvas = (max(s[0] for s in family_sizes),
              max(s[1] for s in family_sizes))
    images = np.zeros((len(cams_meta),) + canvas + (3,), np.uint8)
    for i, c in enumerate(cams_meta):
        w, h = family_sizes[families[i]]
        images[i, :w, :h] = load_image(c["path"], (w, h))

    mapping = _family_non_static(mapping, images, families,
                                 n_sample=n_sample)
    save_area(out_path, {
        "pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
        "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
        "normal": geo["normal"].cpu().numpy(),
        "mapping": mapping,
        "images": images,
        "image_family": families,
        "family_sizes": np.asarray(family_sizes, np.int64),
    })
    return out_path


class CylinderDataset(SphereDataset):
    """Vertical-cylinder variant (KITTI360Cylinder, kitti360.py:203-744)."""

    def __post_init__(self):
        super().__post_init__()
        self.select_shape = "cylinder"


def _split_windows(root: str, train: bool) -> List[str]:
    """The window PLYs of a split: the official list under
    ``data_3d_semantics/`` or ``data_3d_semantics/train/`` (the release
    layouts differ), else a deterministic 90/10 split by window name with a
    warning (every tenth window is val; all of them when that leaves the
    split empty)."""
    split = "train" if train else "val"
    candidates = [
        os.path.join(root, "data_3d_semantics", f"2013_05_28_drive_{split}.txt"),
        os.path.join(root, "data_3d_semantics", "train",
                     f"2013_05_28_drive_{split}.txt"),
    ]
    split_list = next((c for c in candidates if os.path.exists(c)), None)
    if split_list:
        with open(split_list) as f:
            listed = [os.path.join(root, l.strip()) for l in f if l.strip()]
        return [p for p in listed if os.path.exists(p)]
    all_plys = sorted(glob.glob(os.path.join(
        root, "data_3d_semantics", "*", "static", "*.ply")))
    warnings.warn("KITTI-360 split lists not found; using a deterministic "
                  "90/10 window split")
    plys = [p for i, p in enumerate(all_plys) if (i % 10 != 0) == train]
    return plys or all_plys   # tiny corpora: better overlapped than empty


def make_kitti360_dataset(
    root: str, train: bool = True, radius: float = 6.0,
    voxel_size: float = 0.05, image_slots: int = 4,
    samples_per_epoch: int = 2000, cache_dir: Optional[str] = None,
    sequences: Optional[List[str]] = None,
    mapping_params: Optional[dict] = None, aug_params: Optional[dict] = None,
    device="cuda", **preprocess_kw,
) -> CylinderDataset:
    """Cylinders of the train or val windows; caches under
    ``<root>/processed_dva`` unless ``cache_dir``, built on ``device``.
    ``mapping_params`` / ``aug_params``: the ingested reference data-YAML
    transform chain (see ``make_s3dis_dataset``; kitti360-sparse sets
    image_r_max=20, image_k_swell=1.5, exact splatting, jitter
    sigma=0.003/clip=0.01 and 0.2/0.2/0.2 ColorJitter).  With
    ``use_fisheye`` (the default) the dataset's ``image_families`` are the
    pinhole ``image_size`` and the ``fisheye_size``."""
    cache_dir = cache_dir or os.path.join(root, "processed_dva")
    mp = dict(mapping_params or {})
    for drop in ("crop_padding", "proj_upscale", "density", "occlusion"):
        mp.pop(drop, None)
    if "exact" in mp:
        preprocess_kw.setdefault("exact_splatting", mp.pop("exact"))
    preprocess_kw.update(mp)
    ds_kw = dataset_aug_kwargs(aug_params, train)
    use_fisheye = preprocess_kw.setdefault("use_fisheye", True)
    image_size = tuple(preprocess_kw.get("image_size", (704, 188)))
    fisheye_size = tuple(preprocess_kw.get("fisheye_size", (350, 350)))
    plys = _split_windows(root, train)
    if sequences:
        plys = [p for p in plys if any(s in p for s in sequences)]
    if not plys:
        raise FileNotFoundError(f"no KITTI-360 windows under {root}")
    paths = [
        preprocess_kitti360_window(root, p, cache_dir, voxel_size=voxel_size,
                                   device=device, **preprocess_kw)
        for p in plys
    ]
    return CylinderDataset(
        areas=AreaCache(paths, max_loaded=3),
        radius=radius, voxel_size=voxel_size, num_classes=NUM_CLASSES,
        train=train,
        augment=build_augment(aug_params,
                              default_augment()) if train else None,
        image_slots=image_slots, samples_per_epoch=samples_per_epoch,
        # pinhole + native-aspect fisheye camera-family buckets
        image_families=([image_size, fisheye_size] if use_fisheye else None),
        **{
            # kitti360-sparse.yaml:135-140 radiometric augmentation
            "color_jitter": (0.2, 0.2, 0.2) if train else None,
            **ds_kw,
        },
    )


def write_submission(out_dir: str, window_preds: Dict[str, np.ndarray]) -> str:
    """Benchmark submission: per-window ``{seq}_{start}_{end}.npy`` of
    ORIGINAL label ids (TRAINID2ID remap) as uint8, zipped into
    ``submission.zip`` (kitti360_tracker.py:259-297); returns the zip's
    path."""
    os.makedirs(out_dir, exist_ok=True)
    zpath = os.path.join(out_dir, "submission.zip")
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as z:
        for name, train_preds in window_preds.items():
            ids = TRAINID2ID[np.clip(train_preds, 0, NUM_CLASSES - 1)]
            npy_path = os.path.join(out_dir, f"{name}.npy")
            np.save(npy_path, ids.astype(np.uint8))
            z.write(npy_path, arcname=f"{name}.npy")
    return zpath
