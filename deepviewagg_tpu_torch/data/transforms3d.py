"""3D transforms: augmentation + sampling, host-side numpy.

The port of ``deepviewagg_tpu/data/transforms3d.py``, every name of it,
copied so that the same ``np.random.Generator`` draws give the same arrays.
The reference's ~60-transform chain (core/data_transform/transforms.py,
grid_transform.py, features.py) reduced to the set its multimodal configs
compose, on a plain dict cloud ``{pos, rgb?, labels?, normal?, mapping?,
...}``: RandomRotate / RandomScaleAnisotropic / RandomNoise / RandomSymmetry
(transforms.py:463-565, features.py:30-108), ElasticDistortion
(grid_transform.py:194), RandomDropout (transforms.py:726+), sphere and
cylinder sampling with id tracking (transforms.py:301,353), quantized
re-voxelization that merges the mappings through the voxel inverse
(GridSampling3D, grid_transform.py:87 + SelectMappingFromPointId), the crop
/ dropout family, the chromatic and feature-composition transforms and the
filters.  ``RandomWalkDropout`` and ``DensityFilter`` find their neighbours
with the port's exact kNN on their ``device`` (the card by default).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import knn as _knn
from ..ops import voxel as _voxel

__all__ = [
    "Compose", "RandomRotate", "RandomScaleAnisotropic", "RandomNoise",
    "RandomSymmetry", "ElasticDistortion", "RandomDropout", "select_rows",
    "sphere_select", "cylinder_select", "quantize_cloud",
    # crop / dropout family (transforms.py:665-1123)
    "SphereCrop", "CubeCrop", "EllipsoidCrop", "RandomSphereDropout",
    "FixedSphereDropout", "RandomWalkDropout", "DensityFilter",
    "PeriodicSampling", "ShuffleData", "ShiftVoxels", "RandomTranslation",
    # chromatic / feature composition (feature_augment.py, features.py)
    "ChromaticTranslation", "ChromaticAutoContrast", "ChromaticJitter",
    "DropFeature", "XYZFeature", "AddOnes", "AddFeatsByKeys",
    # transforms.py, features.py, filters.py, sparse_transforms.py,
    # precollate.py, __init__.py
    "Random3AxisRotation", "RandomCoordsFlip", "NormalizeRGB",
    "NormalizeFeature", "ScalePos", "RemoveAttributes", "AddFeatByKey",
    "LotteryTransform", "RandomParamTransform", "IrregularSampling",
    "CylinderNormalizeScale", "planarity_filter",
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


class ElasticDistortion:
    """Smoothed random displacement field (grid_transform.py:194-240)."""

    def __init__(self, granularity=(0.2, 0.8), magnitude=(0.4, 1.6)):
        # reference defaults (grid_transform.py:211): magnitudes in METERS at
        # distortion-field strength — 10x weaker values make it a no-op
        self.granularity = granularity
        self.magnitude = magnitude

    def __call__(self, cloud, rng):
        cloud = dict(cloud)
        pos = cloud["pos"].astype(np.float32)
        for g, m in zip(self.granularity, self.magnitude):
            lo = pos.min(0)
            dims = np.maximum(((pos.max(0) - lo) / g).astype(int) + 3, 2)
            noise = rng.normal(0, 1, tuple(dims) + (3,)).astype(np.float32)
            # cheap separable box blur x3
            for ax in range(3):
                k = np.ones(3) / 3
                noise = np.apply_along_axis(
                    lambda a: np.convolve(a, k, mode="same"), ax, noise
                )
            idx = ((pos - lo) / g).astype(int) + 1
            idx = np.minimum(idx, np.array(dims) - 1)
            disp = noise[idx[:, 0], idx[:, 1], idx[:, 2]]
            pos = pos + disp * m
        cloud["pos"] = pos
        return cloud


class RandomDropout:
    """Drop a random fraction of points, tracking row selection through
    labels/feats/mapping (transforms.py:726+)."""

    def __init__(self, dropout_ratio=0.2, p=0.5):
        self.ratio, self.p = dropout_ratio, p

    def __call__(self, cloud, rng):
        if rng.random() > self.p:
            return cloud
        n = len(cloud["pos"])
        keep = np.sort(
            rng.choice(n, int(n * (1 - self.ratio)), replace=False)
        )
        return select_rows(cloud, keep)


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


def sphere_crop_count(cloud: dict, point_max: int, rng, center=None) -> dict:
    """The ``point_max`` points nearest ``center`` (by default a point
    drawn uniformly from the cloud), nearest first; a cloud of at most
    ``point_max`` points is returned whole (Pointcept's ``SphereCrop(
    point_max, mode="random")``).  The port's own name, not in the JAX
    module's list."""
    pos = cloud["pos"]
    if len(pos) <= point_max:
        return cloud
    if center is None:
        center = pos[int(rng.integers(len(pos)))]
    d = np.sum(np.square(pos - np.asarray(center, pos.dtype)[None]), axis=1)
    return select_rows(cloud, np.argsort(d, kind="stable")[:point_max])


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


# --------------------------------------------------------------------------
# Crop / dropout family (ref transforms.py:726-1123): every row reduction
# rides select_rows so labels/feats/mapping follow.
# --------------------------------------------------------------------------

class SphereCrop:
    """Crop to a random sphere of ``radius`` centered on a random point
    (ref SphereCrop, transforms.py:910; default radius 50 per :922)."""

    def __init__(self, radius: float = 50.0):
        self.radius = radius

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        c = pos[int(rng.integers(len(pos)))]
        keep = np.nonzero(np.linalg.norm(pos - c, axis=1) < self.radius)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class CubeCrop:
    """Crop to a random axis-aligned cube of side ``2 * c`` after an
    optional random z-rotation (ref CubeCrop, transforms.py:939)."""

    def __init__(self, c: float = 1.0, rot_z: bool = True):
        self.c = c
        self.rot_z = rot_z

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        center = pos[int(rng.integers(len(pos)))]
        rel = pos - center
        if self.rot_z:
            rel = rel @ _rot_z(rng.uniform(-np.pi, np.pi)).T
        keep = np.nonzero((np.abs(rel) <= self.c).all(axis=1))[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class EllipsoidCrop:
    """Crop to a random ellipsoid with semi-axes (a, b, c)
    (ref EllipsoidCrop, transforms.py:982)."""

    def __init__(self, a: float = 1.0, b: float = 1.0, c: float = 1.0):
        self.abc = np.array([a, b, c], np.float32)

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        center = pos[int(rng.integers(len(pos)))]
        rel = (pos - center) / self.abc
        keep = np.nonzero(np.sum(rel * rel, axis=1) < 1.0)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class RandomSphereDropout:
    """Delete points inside ``num_sphere`` random spheres of ``radius``
    (ref RandomSphereDropout, transforms.py:834)."""

    def __init__(self, num_sphere: int = 10, radius: float = 5.0):
        self.num_sphere = num_sphere
        self.radius = radius

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        drop = np.zeros(len(pos), bool)
        for _ in range(self.num_sphere):
            c = pos[int(rng.integers(len(pos)))]
            drop |= np.linalg.norm(pos - c, axis=1) < self.radius
        keep = np.nonzero(~drop)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class FixedSphereDropout:
    """Delete points inside spheres at FIXED centers (ref
    FixedSphereDropout, transforms.py:873) — reproducible occlusions."""

    def __init__(self, centers, radius: float = 5.0):
        self.centers = np.asarray(centers, np.float32).reshape(-1, 3)
        self.radius = radius

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        drop = np.zeros(len(pos), bool)
        for c in self.centers:
            drop |= np.linalg.norm(pos - c, axis=1) < self.radius
        keep = np.nonzero(~drop)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


def _knn_on(pos, k: int, device):
    """The exact ``k`` nearest of each point of ``pos`` among them, found on
    ``device``: ``(d2 float32, idx int64)`` as numpy."""
    p = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    d2, idx = _knn.knn(p, p, k)
    return d2.cpu().numpy(), idx.cpu().numpy()


class RandomWalkDropout:
    """Delete points visited by a random walk over the kNN graph
    (ref RandomWalkDropout, transforms.py:778): simulates scan shadows.
    The kNN graph is built on ``device``."""

    def __init__(self, dropout_ratio: float = 0.05, num_iter: int = 5000,
                 k: int = 8, restart_p: float = 0.04, device="cuda"):
        self.ratio = dropout_ratio
        self.num_iter = num_iter
        self.k = k
        self.restart_p = restart_p
        self.device = device

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        n = len(pos)
        _, nbrs = _knn_on(pos, min(self.k + 1, n), self.device)
        nbrs = nbrs[:, 1:]                      # drop self
        keep_mask = np.ones(n, bool)
        cur = int(rng.integers(n))
        for _ in range(min(self.num_iter, int(n * self.ratio * 25))):
            keep_mask[cur] = False
            if rng.random() < self.restart_p:
                cur = int(rng.integers(n))
            else:
                cur = int(nbrs[cur][int(rng.integers(nbrs.shape[1]))])
        keep = np.nonzero(keep_mask)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class DensityFilter:
    """Drop points with fewer than ``min_num`` neighbors inside
    ``radius_nn`` (ref DensityFilter, transforms.py:1030), counted among
    the ``k`` nearest found on ``device``."""

    def __init__(self, radius_nn: float = 0.04, min_num: int = 6, k: int = 16,
                 device="cuda"):
        self.radius_nn = radius_nn
        self.min_num = min_num
        self.k = k
        self.device = device

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        d2, _ = _knn_on(pos, min(self.k, len(pos)), self.device)
        counts = (d2 <= self.radius_nn ** 2).sum(axis=1) - 1
        keep = np.nonzero(counts >= self.min_num)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class PeriodicSampling:
    """Keep points whose distance to an anchor is within a periodic band
    (ref PeriodicSampling, transforms.py:1095)."""

    def __init__(self, period: float = 0.1, prop: float = 0.1,
                 box_multiplier: float = 1.0):
        self.period = period
        self.prop = prop
        self.box_multiplier = box_multiplier

    def __call__(self, cloud, rng):
        pos = cloud["pos"]
        lo, hi = pos.min(0), pos.max(0)
        anchor = lo + rng.uniform(0, 1, 3) * (hi - lo) * self.box_multiplier
        d = np.linalg.norm(pos - anchor.astype(np.float32), axis=1)
        keep = np.nonzero((d % self.period) < self.period * self.prop)[0]
        return select_rows(cloud, keep) if len(keep) >= 16 else cloud


class ShuffleData:
    """Random row permutation (ref ShuffleData, transforms.py:665) — breaks
    any file-order correlation before capacity-cropped batching."""

    def __call__(self, cloud, rng):
        n = len(cloud["pos"])
        order = rng.permutation(n)
        out = dict(cloud)
        for k, v in cloud.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
                out[k] = v[order]
        if cloud.get("mapping") is not None:
            # point i moves to row inv[i]; merge_points with the inverse
            # permutation remaps view point-ids and re-sorts the tables
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            out["mapping"] = cloud["mapping"].merge_points(inv, n)
        return out


class ShiftVoxels:
    """Shift quantized coords by a random positive offset so sparse convs
    see both even and odd alignments (ref ShiftVoxels, transforms.py:699).
    Apply AFTER quantize_cloud."""

    def __init__(self, apply_shift: bool = True):
        self.apply_shift = apply_shift

    def __call__(self, cloud, rng):
        if not self.apply_shift or cloud.get("coords") is None:
            return cloud
        out = dict(cloud)
        out["coords"] = (
            cloud["coords"] + rng.integers(0, 100, 3).astype(np.int32)
        )
        return out


class RandomTranslation:
    """Uniform global position jitter (ref RandomTranslation,
    features.py:84)."""

    def __init__(self, delta: float = 0.1):
        self.delta = delta

    def __call__(self, cloud, rng):
        out = dict(cloud)
        t = rng.uniform(-self.delta, self.delta, 3).astype(np.float32)
        out["pos"] = cloud["pos"] + t
        return out


# --------------------------------------------------------------------------
# Chromatic / feature transforms (ref feature_augment.py + features.py)
# --------------------------------------------------------------------------

class ChromaticTranslation:
    """Global random color shift, clamped to [0, 1] (feature_augment.py:28)."""

    def __init__(self, trans_range_ratio: float = 0.1, p: float = 0.95):
        self.ratio = trans_range_ratio
        self.p = p

    def __call__(self, cloud, rng):
        if cloud.get("rgb") is None or rng.random() > self.p:
            return cloud
        out = dict(cloud)
        tr = (rng.uniform(0, 1, (1, 3)) - 0.5) * 2 * self.ratio
        out["rgb"] = np.clip(cloud["rgb"] + tr.astype(np.float32), 0, 1)
        return out


class ChromaticAutoContrast:
    """Blend colors toward their min-max rescale (feature_augment.py:52)."""

    def __init__(self, randomize_blend_factor: bool = True,
                 blend_factor: float = 0.5, p: float = 0.2):
        self.randomize = randomize_blend_factor
        self.blend = blend_factor
        self.p = p

    def __call__(self, cloud, rng):
        if cloud.get("rgb") is None or rng.random() > self.p:
            return cloud
        rgb = cloud["rgb"]
        lo, hi = rgb.min(0, keepdims=True), rgb.max(0, keepdims=True)
        scale = 1.0 / np.maximum(hi - lo, 1e-6)
        contrast = (rgb - lo) * scale
        b = rng.random() if self.randomize else self.blend
        out = dict(cloud)
        out["rgb"] = ((1 - b) * rgb + b * contrast).astype(np.float32)
        return out


class ChromaticJitter:
    """Per-point gaussian color noise, clamped (feature_augment.py:90)."""

    def __init__(self, std: float = 0.01, p: float = 0.95):
        self.std = std
        self.p = p

    def __call__(self, cloud, rng):
        if cloud.get("rgb") is None or rng.random() > self.p:
            return cloud
        out = dict(cloud)
        noise = rng.normal(0, self.std, cloud["rgb"].shape).astype(np.float32)
        out["rgb"] = np.clip(cloud["rgb"] + noise, 0, 1)
        return out


class DropFeature:
    """Zero one feature column with probability p (feature_augment.py:115)."""

    def __init__(self, drop_proba: float = 0.2, feature_name: str = "rgb"):
        self.p = drop_proba
        self.key = feature_name

    def __call__(self, cloud, rng):
        if cloud.get(self.key) is None or rng.random() > self.p:
            return cloud
        out = dict(cloud)
        out[self.key] = np.zeros_like(cloud[self.key])
        return out


class XYZFeature:
    """Append (a subset of) the raw xyz coordinates as features
    (ref XYZFeature, features.py:604): stored under ``cloud['xyz_feat']``
    for AddFeatsByKeys to compose."""

    def __init__(self, add_x: bool = True, add_y: bool = True,
                 add_z: bool = True):
        self.axes = [i for i, a in enumerate((add_x, add_y, add_z)) if a]

    def __call__(self, cloud, rng=None):
        out = dict(cloud)
        out["xyz_feat"] = cloud["pos"][:, self.axes].astype(np.float32)
        return out


class AddOnes:
    """Constant-one feature column (ref AddOnes, features.py:590)."""

    def __call__(self, cloud, rng=None):
        out = dict(cloud)
        out["ones"] = np.ones((len(cloud["pos"]), 1), np.float32)
        return out


class AddFeatsByKeys:
    """Concatenate named per-point arrays into ``cloud['feats']``
    (ref AddFeatsByKeys, features.py:109 — the declarative feature
    composition every reference dataset config uses)."""

    def __init__(self, keys: Sequence[str]):
        self.keys = list(keys)

    def __call__(self, cloud, rng=None):
        cols = []
        for k in self.keys:
            v = cloud.get(k)
            if v is None:
                raise KeyError(f"AddFeatsByKeys: missing '{k}'")
            v = np.asarray(v, np.float32)
            cols.append(v[:, None] if v.ndim == 1 else v)
        out = dict(cloud)
        out["feats"] = np.concatenate(cols, axis=1)
        return out


def _rot_axis(axis: int, theta: float) -> np.ndarray:
    """Rotation matrix about coordinate axis 0/1/2."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3, dtype=np.float32)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    m[a, a] = c
    m[b, b] = c
    m[a, b] = -s if axis != 1 else s
    m[b, a] = s if axis != 1 else -s
    return m


class Random3AxisRotation:
    """Random rotation about each axis within per-axis degree bounds,
    composed in random order (ref Random3AxisRotation, features.py:30-79)."""

    def __init__(self, rot_x: float = 0.0, rot_y: float = 0.0,
                 rot_z: float = 0.0, apply_rotation: bool = True):
        if apply_rotation and not (rot_x or rot_y or rot_z):
            raise ValueError("at least one rot_* must be set")
        self.limits = [abs(rot_x or 0.0), abs(rot_y or 0.0), abs(rot_z or 0.0)]
        self.apply_rotation = apply_rotation

    def __call__(self, cloud, rng):
        if not self.apply_rotation:
            return cloud
        mats = []
        for axis, deg in enumerate(self.limits):
            if deg > 0:
                theta = np.deg2rad(rng.uniform(-deg, deg))
                mats.append(_rot_axis(axis, theta))
        order = rng.permutation(len(mats))
        r = np.eye(3, dtype=np.float32)
        for i in order:
            r = mats[i] @ r
        out = dict(cloud)
        out["pos"] = (cloud["pos"] @ r.T).astype(np.float32)
        if cloud.get("normal") is not None:
            out["normal"] = (cloud["normal"] @ r.T).astype(np.float32)
        return out


class RandomCoordsFlip:
    """Flip positions along each non-ignored axis with probability ``p``
    (ref RandomCoordsFlip, sparse_transforms.py:24-55: coord -> max - coord)."""

    def __init__(self, ignored_axis: str = "z", p: float = 0.95):
        mapping = {"x": 0, "y": 1, "z": 2}
        ignored = {mapping[a] for a in ignored_axis}
        self.axes = sorted(set(range(3)) - ignored)
        self.p = p

    def __call__(self, cloud, rng):
        out = dict(cloud)
        pos = np.array(cloud["pos"], np.float32)
        for ax in self.axes:
            if rng.random() < self.p:
                pos[:, ax] = pos[:, ax].max() - pos[:, ax]
        out["pos"] = pos
        return out


class NormalizeRGB:
    """Scale rgb to [0, 1] when it still looks like bytes
    (ref NormalizeRGB, feature_augment.py:7-22)."""

    def __call__(self, cloud, rng=None):
        rgb = cloud.get("rgb")
        if rgb is None:
            return cloud
        out = dict(cloud)
        rgb = np.asarray(rgb, np.float32)
        if rgb.max() > 1.0 or rgb.min() < 0.0:
            rgb = rgb / 255.0
        out["rgb"] = rgb
        return out


class NormalizeFeature:
    """Min-max scale (or standardize) one named per-point array
    (ref NormalizeFeature, precollate.py:3-24)."""

    def __init__(self, feature_name: str, standardize: bool = False):
        self.feature_name = feature_name
        self.standardize = standardize

    def __call__(self, cloud, rng=None):
        v = np.asarray(cloud[self.feature_name], np.float32)
        if self.standardize:
            v = (v - v.mean()) / max(v.std(), 1e-12)
        else:
            v = (v - v.min()) / max(v.max() - v.min(), 1e-12)
        out = dict(cloud)
        out[self.feature_name] = v
        return out


class ScalePos:
    """Multiply positions by a constant (ref ScalePos, transforms.py:513)."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def __call__(self, cloud, rng=None):
        out = dict(cloud)
        out["pos"] = np.asarray(cloud["pos"], np.float32) * self.scale
        return out


class RemoveAttributes:
    """Drop named keys from the cloud (ref RemoveAttributes,
    transforms.py:31-55; strict=True raises on absent keys)."""

    def __init__(self, attr_names: Sequence[str], strict: bool = False):
        self.attr_names = list(attr_names)
        self.strict = strict

    def __call__(self, cloud, rng=None):
        out = dict(cloud)
        for k in self.attr_names:
            if k in out:
                del out[k]
            elif self.strict:
                raise KeyError(k)
        return out


class AddFeatByKey:
    """Append one named array to ``feats`` (ref AddFeatByKey,
    features.py:200 — the singular form of AddFeatsByKeys)."""

    def __init__(self, feat_name: str, add_to_x: bool = True):
        self.feat_name = feat_name
        self.add_to_x = add_to_x

    def __call__(self, cloud, rng=None):
        if not self.add_to_x:
            return cloud
        v = np.asarray(cloud[self.feat_name], np.float32)
        v = v[:, None] if v.ndim == 1 else v
        out = dict(cloud)
        base = cloud.get("feats")
        out["feats"] = v if base is None else np.concatenate(
            [np.asarray(base, np.float32), v], axis=1)
        return out


class LotteryTransform:
    """Apply one transform drawn uniformly from a list per call
    (ref LotteryTransform, data_transform/__init__.py:104)."""

    def __init__(self, transform_options: Sequence):
        self.transforms = list(transform_options)

    def __call__(self, cloud, rng):
        t = self.transforms[int(rng.integers(len(self.transforms)))]
        return t(cloud, rng)


class RandomParamTransform:
    """Instantiate a transform with freshly drawn random parameters each
    call (ref RandomParamTransform, data_transform/__init__.py:167): params
    are ``{name: {"min": a, "max": b, "type": "float"|"int"}}`` or
    ``{name: {"value": v}}``."""

    def __init__(self, transform_cls, transform_params: dict):
        self.cls = transform_cls
        self.params = dict(transform_params)

    def __call__(self, cloud, rng):
        kw = {}
        for name, spec in self.params.items():
            if "value" in spec:
                kw[name] = spec["value"]
            elif spec.get("type") == "int":
                kw[name] = int(rng.integers(spec["min"], spec["max"] + 1))
            else:
                kw[name] = float(rng.uniform(spec["min"], spec["max"]))
        return self.cls(**kw)(cloud, rng)


class IrregularSampling:
    """Soft crop: keep points with probability exp(-|p - c|^p / 2 sigma^2),
    sigma derived so the keep-probability halves at ``d_half``
    (ref IrregularSampling, transforms.py:1064-1093)."""

    def __init__(self, d_half: float = 2.5, p: float = 2.0):
        self.d_half = d_half
        self.p = p

    def __call__(self, cloud, rng):
        pos = np.asarray(cloud["pos"], np.float32)
        center = pos[int(rng.integers(len(pos)))]
        d_p = (np.abs(pos - center) ** self.p).sum(1)
        sigma2 = (self.d_half ** self.p) / (2 * np.log(2))
        keep = rng.random(len(pos)) < np.exp(-d_p / (2 * sigma2))
        if not keep.any():
            keep[int(rng.integers(len(pos)))] = True
        return select_rows(cloud, np.nonzero(keep)[0])


class CylinderNormalizeScale:
    """Center then scale xy (and optionally z) into [-1, 1]
    (ref CylinderNormalizeScale, transforms.py:435-459)."""

    def __init__(self, normalize_z: bool = True):
        self.normalize_z = normalize_z

    def __call__(self, cloud, rng=None):
        out = dict(cloud)
        pos = np.array(cloud["pos"], np.float32)
        pos -= pos.mean(0, keepdims=True)
        pos[:, :2] *= 0.999999 / max(np.abs(pos[:, :2]).max(), 1e-12)
        if self.normalize_z:
            pos[:, 2] *= 0.999999 / max(np.abs(pos[:, 2]).max(), 1e-12)
        out["pos"] = pos
        return out


def planarity_filter(cloud, thresh: float = 0.3, is_leq: bool = True) -> bool:
    """True if the cloud passes the planarity gate (ref PlanarityFilter,
    filters.py:38-63): planarity = (l2 - l3) / l1 of the global PCA."""
    pos = np.asarray(cloud["pos"], np.float64)
    centered = pos - pos.mean(0, keepdims=True)
    cov = centered.T @ centered / max(len(pos), 1)
    evals = np.sort(np.linalg.eigvalsh(cov))[::-1]
    planarity = (evals[1] - evals[2]) / max(evals[0], 1e-12)
    return bool(planarity <= thresh) if is_leq else bool(planarity > thresh)
