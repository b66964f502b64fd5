"""A synthetic KITTI-360 street window, held in memory.

A street along x (road, sidewalks, facades, parked cars, trees, poles and
low clutter, at a point density per square metre of surface) with the
vehicle's drive along it: at every ``frame_step``-th frame the forward
pinhole camera (cam0, the release's ``P_rect_00`` scaled to the recipe's
704 x 188) and the two MEI fisheyes (cam2 left, cam3 right, the release's
calibration scaled to 350 x 350), posed as on the KITTI-360 vehicle.  The
window goes through the port's own preprocessing steps (voxel grid, PCA
features, mappings, coverage selection of ``max_images``) and its
``CylinderDataset`` with the recipe's augmentations and camera-family
buckets, over an in-memory stand-in for the cache files.  Frames are drawn
on the device: each point's colour at its projection, nearest last, over a
smooth background.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["street_dataset"]

# KITTI-360 semantic ids of the street's parts
_IDS = {"road": 7, "sidewalk": 8, "building": 11, "pole": 17,
        "vegetation": 21, "car": 26, "unlabelled": 0}
# the release's calibration (perspective.txt P_rect_00, image_02/03.yaml)
_P_RECT = np.array([[552.55, 0.0, 682.05], [0.0, 552.55, 238.77],
                    [0.0, 0.0, 1.0]], np.float32)
_PERSP_SIZE = (1408, 376)
_FISHEYE = np.array([2.2134047507854890, 1.6798235660113681e-02,
                     1.6548773243373522, 1.3363220825849971e+03,
                     1.3357883350012958e+03, 7.1694323510126321e+02,
                     7.0576498308221585e+02], np.float32)
_FISHEYE_SIZE = (1400, 1400)
# camera axes in the vehicle frame (cam0 along +x, cam2 +y, cam3 -y) and
# the cameras' offsets on the vehicle
_AXES = {0: ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
         2: ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0)),
         3: ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0))}
_OFFSET = {0: (1.5, 0.0, 0.0), 2: (0.8, 0.5, 0.1), 3: (0.8, -0.5, 0.1)}


def _street(x0, x1, density, rng):
    parts = []

    def add(p, name, colour):
        parts.append((p, _IDS[name], colour))

    length = x1 - x0
    n = int(density * length * 14.0)
    g = rng.uniform((x0, -7.0, 0.0), (x1, 7.0, 0.0), (n, 3))
    road = np.abs(g[:, 1]) < 3.5
    add(g[road], "road", (80, 80, 85))
    add(g[~road], "sidewalk", (150, 140, 130))
    n = int(density * length * 8.0)
    for side, colour in ((-1.0, (200, 190, 160)), (1.0, (170, 120, 90))):
        add(rng.uniform((x0, 7.0 * side, 0.0), (x1, 7.0 * side, 8.0), (n, 3)),
            "building", colour)
    for k, cx in enumerate(np.arange(x0 + 2.0, x1 - 4.0, 12.0)):
        side = 1.0 if k % 2 else -1.0
        n = int(density * 20.0)
        c = rng.uniform((cx, 1.8, 0.0), (cx + 4.2, 3.4, 1.5), (n, 3))
        face = rng.integers(0, 4, n)
        c[face == 0, 1] = 1.8
        c[face == 1, 2] = 1.5
        c[face == 2, 0] = cx
        c[face == 3, 0] = cx + 4.2
        c[:, 1] *= side
        add(c, "car", (30, 60, 160) if k % 3 else (160, 30, 30))
    for cx in np.arange(x0 + 6.0, x1, 15.0):
        n = int(density * 12.0)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        add(d * 1.2 + (cx, 5.0, 4.0), "vegetation", (40, 140, 50))
        n = int(density * 3.0)
        a = rng.uniform(0, 2 * np.pi, n)
        add(np.stack([cx + 3.0 + 0.1 * np.cos(a), -5.0 + 0.1 * np.sin(a),
                      rng.uniform(0, 6.0, n)], 1), "pole", (110, 110, 110))
    n = int(density * length * 0.3)
    add(rng.uniform((x0, -7.0, 0.0), (x1, 7.0, 0.6), (n, 3)), "unlabelled",
        (120, 120, 120))
    pos = np.concatenate([p for p, _, _ in parts])
    pos = (pos + rng.normal(0.0, 0.02, pos.shape)).astype(np.float32)
    sem = np.concatenate([np.full(len(p), i, np.int32) for p, i, _ in parts])
    rgb = np.concatenate([
        np.clip(np.asarray(c, np.float64) + rng.normal(0, 12, (len(p), 3)),
                0, 255) for p, _, c in parts]).astype(np.float32) / 255.0
    return pos, rgb, sem


def _cameras(frames, speed, pin_size, fish_size, r_min, r_max):
    from deepviewagg_tpu_torch.core.cameras import Camera

    k = np.eye(4, dtype=np.float32)
    k[:3, :3] = _P_RECT
    k[0] *= pin_size[0] / _PERSP_SIZE[0]
    k[1] *= pin_size[1] / _PERSP_SIZE[1]
    fe = _FISHEYE * np.array([1, 1, 1, fish_size[0] / _FISHEYE_SIZE[0],
                              fish_size[1] / _FISHEYE_SIZE[1],
                              fish_size[0] / _FISHEYE_SIZE[0],
                              fish_size[1] / _FISHEYE_SIZE[1]], np.float32)
    cams, fams = [], []
    for cam in (0, 2, 3):
        for frame in frames:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.array(_AXES[cam], np.float32).T
            pose[:3, 3] = np.array((frame * speed, 0.0, 1.7)) + _OFFSET[cam]
            if cam == 0:
                cams.append(Camera(model="kitti360_perspective",
                                   size=tuple(pin_size), extrinsic=pose,
                                   intrinsic=k, r_min=r_min, r_max=r_max))
            else:
                cams.append(Camera(model="kitti360_fisheye",
                                   size=tuple(fish_size), extrinsic=pose,
                                   fisheye=fe, r_min=r_min, r_max=r_max))
            fams.append(0 if cam == 0 else 1)
    return cams, np.asarray(fams, np.int64)


def _frame(pos_dev, rgb_dev, camera) -> np.ndarray:
    """``uint8 [W, H, 3]`` of ``camera``."""
    from deepviewagg_tpu_torch.core.cameras import project

    w, h = camera.size
    dev = pos_dev.device
    x, y = torch.meshgrid(torch.arange(w, device=dev, dtype=torch.float32),
                          torch.arange(h, device=dev, dtype=torch.float32),
                          indexing="ij")
    img = torch.stack([torch.sin(x / 53.0) * 40 + 120,
                       torch.cos(y / 41.0) * 35 + 110,
                       (x + y) * (60.0 / (w + h)) + 90], dim=-1)
    px, py, dist, valid = project(pos_dev, camera)
    order = torch.argsort(-dist[valid], stable=True)
    xi, yi = px[valid].long()[order], py[valid].long()[order]
    col = rgb_dev[valid][order] * 255.0
    for dx in (0, 1):
        for dy in (0, 1):
            img[torch.clamp(xi + dx, max=w - 1),
                torch.clamp(yi + dy, max=h - 1)] = col
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


class _Areas:
    """The ``AreaCache`` interface over clouds held in memory."""

    def __init__(self, clouds):
        self.clouds = clouds
        self.paths = [f"street_{i}" for i in range(len(clouds))]

    def __len__(self):
        return len(self.clouds)

    def get(self, idx):
        return self.clouds[idx]


def street_dataset(cfg: Dict, p: Dict, seed: int, device, train: bool = True):
    """The port's ``CylinderDataset`` over one street window made from
    ``seed`` (parameters ``p``: density, frames, speed, behind, ahead,
    max_images, r_min, r_max)."""
    from deepviewagg_tpu_torch.data.datasets import kitti360
    from deepviewagg_tpu_torch.data.datasets.base import build_augment
    from deepviewagg_tpu_torch.data.geometric import pca_features
    from deepviewagg_tpu_torch.data.mapping_factory import (VisibilityParams,
                                                            build_mappings)
    from deepviewagg_tpu_torch.data.transforms2d import \
        select_images_by_coverage
    from deepviewagg_tpu_torch.ops import voxel

    d = cfg["data"]
    rng = np.random.default_rng(seed)
    frames = list(range(0, p["frames"] + 1, p["frame_step"]))
    x0 = -p["behind"]
    x1 = frames[-1] * p["speed"] + p["ahead"]
    pos, rgb, sem = _street(x0, x1, p["density"], rng)
    labels = kitti360.ID2TRAINID[sem]
    vs = d["voxel_size"]
    g = voxel.grid_sample(pos, vs, feats=rgb, labels=labels)
    geo = pca_features(g["pos"], k=p["nbf_k"], device=device)
    pin, fish = d["image_size"], d["fisheye_size"]
    cams, fams = _cameras(frames, p["speed"], pin, fish, p["r_min"],
                          p["r_max"])
    mapping = build_mappings(
        g["pos"], cams, VisibilityParams(voxel=vs), geometric=geo,
        nn_idx=geo["nn_idx"], device=device)
    if mapping.num_images > p["max_images"]:
        keep = select_images_by_coverage(mapping, p["max_images"])
        mapping = mapping.select_images(keep).compact()
        cams = [cams[i] for i in keep]
        fams = fams[keep]
    canvas = (max(pin[0], fish[0]), max(pin[1], fish[1]))
    images = np.zeros((len(cams),) + canvas + (3,), np.uint8)
    pos_dev = torch.as_tensor(pos, device=device)
    rgb_dev = torch.as_tensor(rgb, device=device)
    for i, cam in enumerate(cams):
        w, h = cam.size
        images[i, :w, :h] = _frame(pos_dev, rgb_dev, cam)
    del pos_dev, rgb_dev
    cloud = {"pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
             "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
             "normal": geo["normal"].cpu().numpy(), "mapping": mapping,
             "images": images, "image_family": fams,
             "family_sizes": np.asarray([pin, fish], np.int64)}
    aug = d["augment"]
    return kitti360.CylinderDataset(
        areas=_Areas([cloud]), radius=d["radius"], voxel_size=vs,
        num_classes=cfg["model"]["num_classes"], train=train,
        augment=build_augment(None, kitti360.default_augment())
        if train else None,
        image_slots=d["image_slots"],
        samples_per_epoch=d["samples_per_epoch"],
        image_families=[tuple(pin), tuple(fish)],
        color_jitter=tuple(aug["color_jitter"]) if train else None,
        seed=seed)
