"""Synthetic multimodal scenes: the first-class in-repo test fixture.

The reference validates its whole mapping pipeline with a notebook that
generates room-like colored boxes + random camera poses and propagates point
colors through the mappings (notebooks/synthetic_multimodal_dataset.ipynb,
SURVEY.md §4.2).  Here that generator is a library function so unit /
integration tests and the synthetic dataset config can use it directly.

A scene is a surface-sampled room (floor, ceiling, 4 walls) with a few boxes,
each surface class carrying a distinct label and color; cameras are
equirectangular panoramas at standing height and/or inward-looking pinholes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.cameras import Camera

__all__ = ["SyntheticScene", "make_scene", "render_views"]

CLASSES = ("floor", "ceiling", "wall", "box")


@dataclasses.dataclass
class SyntheticScene:
    pos: np.ndarray       # [N, 3] float32
    rgb: np.ndarray       # [N, 3] float32 in [0, 1]
    labels: np.ndarray    # [N] int32
    cameras: List[Camera]
    boxes: Optional[np.ndarray] = None   # [B, 6] center xyz + size whd


def _sample_plane(rng, origin, u, v, density, color, jitter=0.01):
    area = np.linalg.norm(u) * np.linalg.norm(v)
    n = max(8, int(area * density))
    a = rng.uniform(0, 1, (n, 1))
    b = rng.uniform(0, 1, (n, 1))
    pts = origin[None] + a * u[None] + b * v[None]
    pts = pts + rng.normal(0, jitter, pts.shape)
    col = np.clip(color[None] + rng.normal(0, 0.03, (n, 3)), 0, 1)
    return pts.astype(np.float32), col.astype(np.float32)


def _box(rng, center, size, density, color):
    cx, cy, cz = center
    sx, sy, sz = size
    o = np.array([cx - sx / 2, cy - sy / 2, cz - sz / 2])
    pts, cols = [], []
    ex, ey, ez = np.array([sx, 0, 0]), np.array([0, sy, 0]), np.array([0, 0, sz])
    for origin, u, v in [
        (o, ex, ey), (o + ez, ex, ey),            # bottom, top
        (o, ex, ez), (o + ey, ex, ez),            # front, back
        (o, ey, ez), (o + ex, ey, ez),            # left, right
    ]:
        p, c = _sample_plane(rng, origin, u, v, density, color)
        pts.append(p)
        cols.append(c)
    return np.concatenate(pts), np.concatenate(cols)


def make_scene(
    seed: int = 0,
    room=(6.0, 4.0, 2.6),
    density: float = 600.0,
    n_boxes: int = 3,
    n_cameras: int = 3,
    camera_model: str = "s3dis_equirectangular",
    image_size=(128, 64),
    r_max: float = 8.0,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    lx, ly, lz = room
    ex, ey, ez = np.array([lx, 0, 0]), np.array([0, ly, 0]), np.array([0, 0, lz])
    o = np.zeros(3)
    parts = []  # (pts, rgb, label)

    floor, fc = _sample_plane(rng, o, ex, ey, density, np.array([0.55, 0.45, 0.35]))
    parts.append((floor, fc, 0))
    ceil, cc = _sample_plane(rng, o + ez, ex, ey, density, np.array([0.9, 0.9, 0.9]))
    parts.append((ceil, cc, 1))
    for origin, u, v, col in [
        (o, ex, ez, np.array([0.7, 0.2, 0.2])),
        (o + ey, ex, ez, np.array([0.2, 0.7, 0.2])),
        (o, ey, ez, np.array([0.2, 0.2, 0.7])),
        (o + ex, ey, ez, np.array([0.7, 0.7, 0.2])),
    ]:
        w, wc = _sample_plane(rng, origin, u, v, density, col)
        parts.append((w, wc, 2))
    boxes = []
    for _ in range(n_boxes):
        size = rng.uniform(0.4, 1.2, 3)
        center = np.array([
            rng.uniform(size[0], lx - size[0]),
            rng.uniform(size[1], ly - size[1]),
            size[2] / 2,
        ])
        bp, bc = _box(rng, center, size, density, rng.uniform(0.1, 0.9, 3))
        parts.append((bp, bc, 3))
        boxes.append(np.concatenate([center, size]))

    pos = np.concatenate([p for p, _, _ in parts])
    rgb = np.concatenate([c for _, c, _ in parts])
    labels = np.concatenate(
        [np.full(len(p), lab, np.int32) for p, _, lab in parts]
    )

    cams = []
    for _ in range(n_cameras):
        cpos = np.array([
            rng.uniform(1.0, lx - 1.0),
            rng.uniform(1.0, ly - 1.0),
            rng.uniform(1.3, 1.8),
        ], np.float32)
        if camera_model == "s3dis_equirectangular":
            cams.append(Camera(
                model="s3dis_equirectangular", size=tuple(image_size),
                pos=cpos, opk=rng.uniform(-np.pi, np.pi, 3).astype(np.float32),
                r_min=0.2, r_max=r_max,
            ))
        elif camera_model == "scannet":
            # inward-looking pinhole: cam->world pose (the scannet extrinsic
            # convention — projection inverts internally)
            target = np.array([lx / 2, ly / 2, 1.0])
            fwd = target - cpos
            fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
            up = np.array([0.0, 0.0, 1.0])
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right) + 1e-9
            dn = np.cross(fwd, right)
            r_wc = np.stack([right, dn, fwd])      # world -> cam rows
            extr = np.eye(4, dtype=np.float32)
            extr[:3, :3] = r_wc.T                  # cam -> world rotation
            extr[:3, 3] = cpos
            w, h = image_size
            k = np.eye(4, dtype=np.float32)
            k[0, 0] = k[1, 1] = 0.8 * w
            k[0, 2] = w / 2
            k[1, 2] = h / 2
            cams.append(Camera(
                model="scannet", size=tuple(image_size), extrinsic=extr,
                intrinsic=k, r_min=0.2, r_max=r_max,
            ))
        else:
            raise ValueError(camera_model)
    return SyntheticScene(
        pos=pos, rgb=rgb, labels=labels, cameras=cams,
        boxes=np.asarray(boxes, np.float32) if boxes
        else np.zeros((0, 6), np.float32),
    )


def render_views(scene: SyntheticScene, mapping, image_index: Optional[int] = None):
    """Propagate point RGB through the mappings to synthesize images — the
    notebook's visual check, used here as a numeric integration test.

    Returns ``imgs [I, W, H, 3]`` with zeros where no point maps.
    """
    cams = scene.cameras
    w, h = cams[0].size
    imgs = np.zeros((len(cams), w, h, 3), np.float32)
    v = mapping.view_valid
    q = mapping.pix_valid
    vc = mapping.view_capacity
    view_img = mapping.image_id
    view_pt = mapping.point_id
    pv = np.minimum(mapping.pix_view, vc - 1)
    ok = q & v[pv]
    imgs[view_img[pv[ok]], mapping.pix_x[ok], mapping.pix_y[ok]] = (
        scene.rgb[np.minimum(view_pt[pv[ok]], len(scene.rgb) - 1)]
    )
    if image_index is not None:
        return imgs[image_index]
    return imgs
