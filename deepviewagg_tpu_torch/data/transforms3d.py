"""3D transforms of the sphere path: augmentation + sampling, host numpy.

The port of the part of ``deepviewagg_tpu/data/transforms3d.py`` that
:class:`~deepviewagg_tpu_torch.data.datasets.base.SphereDataset` and
:func:`~deepviewagg_tpu_torch.data.datasets.base.build_augment` reach, copied
so that the same ``np.random.Generator`` draws give the same arrays:
``Compose``, ``RandomRotate``, ``RandomScaleAnisotropic``, ``RandomNoise``,
``RandomSymmetry`` (transforms.py:463-565, features.py:30-108), sphere and
cylinder sampling with id tracking (transforms.py:301,353), and quantized
re-voxelization that merges the mappings through the voxel inverse
(GridSampling3D, grid_transform.py:87 + SelectMappingFromPointId).  The
other transforms of the JAX module are not ported.  A cloud is a plain dict
``{pos, rgb?, labels?, normal?, mapping?, ...}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops import voxel as _voxel

__all__ = [
    "Compose", "RandomRotate", "RandomScaleAnisotropic", "RandomNoise",
    "RandomSymmetry", "select_rows", "sphere_select", "cylinder_select",
    "quantize_cloud",
]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, cloud: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            cloud = t(cloud, rng)
        return cloud


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


class RandomRotate:
    """Rotate about an axis (default z, the reference's vertical-axis
    augmentation).  Rotates ``pos`` and ``normal``."""

    def __init__(self, axis: str = "z", degrees: Optional[float] = None):
        self.axis = axis
        self.degrees = degrees  # None = full circle

    def __call__(self, cloud, rng):
        lim = np.pi if self.degrees is None else np.deg2rad(self.degrees)
        theta = rng.uniform(-lim, lim)
        r = _rot_z(theta)
        if self.axis != "z":
            perm = {"x": [2, 0, 1], "y": [1, 2, 0]}[self.axis]
            p = np.eye(3, dtype=np.float32)[perm]
            r = p.T @ r @ p
        cloud = dict(cloud)
        cloud["pos"] = cloud["pos"] @ r.T
        if cloud.get("normal") is not None:
            cloud["normal"] = cloud["normal"] @ r.T
        return cloud


class RandomScaleAnisotropic:
    def __init__(self, scale_min=0.9, scale_max=1.1):
        self.lo, self.hi = scale_min, scale_max

    def __call__(self, cloud, rng):
        s = rng.uniform(self.lo, self.hi, 3).astype(np.float32)
        cloud = dict(cloud)
        cloud["pos"] = cloud["pos"] * s
        if cloud.get("normal") is not None:
            n = cloud["normal"] / s
            cloud["normal"] = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-9)
        return cloud


class RandomNoise:
    def __init__(self, sigma=0.01, clip=0.05):
        self.sigma, self.clip = sigma, clip

    def __call__(self, cloud, rng):
        cloud = dict(cloud)
        noise = np.clip(
            rng.normal(0, self.sigma, cloud["pos"].shape), -self.clip, self.clip
        ).astype(np.float32)
        cloud["pos"] = cloud["pos"] + noise
        return cloud


class RandomSymmetry:
    """Coin-flip mirror per enabled axis (ref RandomSymmetry,
    transforms.py:463: default all-off; recipes enable x/y explicitly)."""

    def __init__(self, axes=(False, False, False)):
        self.axes = axes

    def __call__(self, cloud, rng):
        cloud = dict(cloud)
        pos = cloud["pos"].copy()
        for i, on in enumerate(self.axes):
            if on and rng.random() < 0.5:
                pos[:, i] = -pos[:, i]
                if cloud.get("normal") is not None:
                    n = cloud["normal"].copy()
                    n[:, i] = -n[:, i]
                    cloud["normal"] = n
        cloud["pos"] = pos
        return cloud



def select_rows(cloud: dict, keep: np.ndarray) -> dict:
    """Row-subset every per-point array + the mapping ('pick' semantics)."""
    out = {}
    n = len(cloud["pos"])
    for k, v in cloud.items():
        if k == "mapping" and v is not None:
            out[k] = v.select_points(keep).compact()
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
            out[k] = v[keep]
        else:
            out[k] = v
    return out


def sphere_select(cloud: dict, center, radius: float) -> dict:
    d = np.linalg.norm(cloud["pos"] - np.asarray(center)[None], axis=1)
    return select_rows(cloud, np.nonzero(d < radius)[0])


def cylinder_select(cloud: dict, center, radius: float) -> dict:
    d = np.linalg.norm(
        cloud["pos"][:, :2] - np.asarray(center)[None, :2], axis=1
    )
    return select_rows(cloud, np.nonzero(d < radius)[0])


def quantize_cloud(cloud: dict, voxel_size: float) -> dict:
    """Re-voxelize after augmentation: points falling into the same voxel are
    merged (features averaged, labels majority), and the mapping follows
    through ``merge_points`` — the role of train-time GridSampling3D with
    ``quantize_coords`` (grid_transform.py:87) + mapping reindex."""
    pos = cloud["pos"]
    feats = cloud.get("rgb")
    g = _voxel.grid_sample(pos, voxel_size, feats=feats,
                           labels=cloud.get("labels"))
    out = dict(cloud)
    out["pos"] = g["pos"]
    out["coords"] = g["coords"][:, 1:]
    if feats is not None:
        out["rgb"] = g["feats"]
    if cloud.get("labels") is not None:
        out["labels"] = g["labels"]
    if cloud.get("normal") is not None:
        m = len(g["coords"])
        acc = np.zeros((m, 3), np.float32)
        np.add.at(acc, g["inverse"], cloud["normal"])
        out["normal"] = acc / (np.linalg.norm(acc, axis=1, keepdims=True) + 1e-9)
    if cloud.get("feats") is not None:
        # composed feature columns (AddFeatsByKeys) average like rgb — never
        # leave a per-point array desynced from the merged voxel rows
        f = np.asarray(cloud["feats"], np.float32)
        m = len(g["coords"])
        acc = np.zeros((m, f.shape[1]), np.float32)
        cnt = np.zeros(m, np.float32)
        np.add.at(acc, g["inverse"], f)
        np.add.at(cnt, g["inverse"], 1.0)
        out["feats"] = acc / np.maximum(cnt, 1.0)[:, None]
    if cloud.get("origin_id") is not None:
        first = np.full(len(g["coords"]), -1, np.int64)
        first[g["inverse"][::-1]] = np.arange(len(pos))[::-1]
        out["origin_id"] = cloud["origin_id"][first]
    if cloud.get("mapping") is not None:
        out["mapping"] = cloud["mapping"].merge_points(
            g["inverse"], len(g["coords"])
        ).compact()
    return out
