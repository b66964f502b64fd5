"""Occlusion-aware visibility on the request's device: splat z-buffering,
the Biasutti and depth-map methods, and the viewing-condition features.

The port of ``deepviewagg_tpu/core/visibility.py`` (the reference's array
formulation, torch_points3d/core/multimodal/visibility.py:631-1605): every
point gets a fixed ``max_splat x max_splat`` pixel grid, pixels outside its
splat bbox are masked, and the z-buffer is two masked scatter-min passes
over a dense ``W*H`` map — a depth race, then a deterministic
smallest-index tie-break.  ``scatter_reduce_("amin")`` gives the same answer
in any order, so the maps are reproducible on the card too.  Exact
splatting then re-maps each winning point to its centre pixel, again by an
order-free reduction.

Splat-size model (visibility.py:647-875): angular width
``(1 + k_swell * exp(-dist / ln(d_swell))) * voxel / dist``, converted to
pixels per camera model; the equirectangular x-width divides by
``sin(pi * y / H)``, the pinhole widths scale by the focal lengths, and the
fisheye width is the pixel shift of the voxel's top.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cameras as _cam

__all__ = [
    "splat_bboxes",
    "splat_zbuffer",
    "splat_zbuffer_batch",
    "project_features",
    "normalize_depth",
    "orientation_to_normal",
    "postprocess_features",
    "depth_map_visibility",
    "biasutti_visibility",
]


def _clamp_bbox(x_a, x_b, y_a, y_b, size, crop_top, crop_bottom):
    w, h = size
    x_a = torch.clamp(x_a, 0, w - 1)
    x_b = torch.clamp(x_b, 1, w)
    y_a = torch.clamp(y_a, crop_top, h - crop_bottom - 1)
    y_b = torch.clamp(y_b, crop_top + 1, h - crop_bottom)
    return x_a, x_b, y_a, y_b


def splat_bboxes(camera: _cam.Camera, xyz, x_proj, y_proj, dist,
                 voxel=0.1, k_swell=1.0, d_swell=1000.0):
    """Per-point splat bbox (x_a, x_b, y_a, y_b) in pixels, int32
    (equirectangular / pinhole / fisheye splats, visibility.py:631-1012)."""
    w, h = camera.size
    swell = 1.0 + k_swell * torch.exp(-dist / math.log(d_swell))
    if camera.model == "s3dis_equirectangular":
        angular_width = swell * voxel / torch.clamp(dist, min=1e-6)
        width_y = angular_width * h / math.pi
        a = angular_width * w / (2.0 * math.pi)
        width_x = a / (torch.sin((math.pi / h) * y_proj) + 0.001)
    elif camera.model in ("scannet", "kitti360_perspective"):
        s = swell * voxel / torch.clamp(dist, min=1e-6)
        k = _cam._tensor(camera.intrinsic, dist.device)
        width_x = s * k[0, 0]
        width_y = s * k[1, 1]
    elif camera.model == "kitti360_fisheye":
        # the pixel shift of the voxel's top is the splat radius
        # (visibility.py:875-930)
        z_off = torch.zeros_like(xyz)
        z_off[:, 2] = swell * voxel / 2
        x2, y2, _ = _cam.fisheye_projection(xyz + z_off, camera.extrinsic,
                                            camera.fisheye)
        width_x = width_y = 2 * torch.sqrt((x_proj - x2) ** 2
                                           + (y_proj - y2) ** 2)
    else:
        raise ValueError(camera.model)

    def rnd(v):   # round half to even, like jnp.round
        return torch.round(v).to(torch.int32)

    x_a = rnd(x_proj - width_x / 2)
    x_b = rnd(x_proj + width_x / 2 + 1)
    y_a = rnd(y_proj - width_y / 2)
    y_b = rnd(y_proj + width_y / 2 + 1)
    return _clamp_bbox(
        x_a, x_b, y_a, y_b, camera.size, camera.crop_top, camera.crop_bottom
    )


def _zbuffer(x_proj, y_proj, dist, valid, bbox, size, max_splat, exact):
    """Dense winner-index map ``int32 [W, H]`` (-1 where nothing is seen).

    ``exact``: only the z-buffer's winning points are kept, each at its
    centre projection pixel (visibility.py:1164-1187, 1273-1284) — one pixel
    per seen point.  Where centres of several winners share a pixel the
    largest point index keeps it: ``scatter_reduce_("amax")`` gives that in
    any order, and it is what the JAX package's ``.at[pix].set(arange(n))``
    gives on the CPU (the last write wins)."""
    w, h = size
    n = dist.shape[0]
    dev = dist.device
    x_a, x_b, y_a, y_b = (b.to(torch.int64) for b in bbox)
    d = torch.arange(max_splat, device=dev)
    px = x_a[:, None, None] + d[None, :, None]             # [N, S, 1]
    py = y_a[:, None, None] + d[None, None, :]             # [N, 1, S]
    m = (valid[:, None, None] & (px < x_b[:, None, None])
         & (py < y_b[:, None, None])).reshape(-1)           # [N*S*S]
    flat_pix = torch.where(m, (px * h + py).reshape(-1), w * h)
    ss = max_splat * max_splat
    flat_depth = dist.repeat_interleave(ss)
    flat_idx = torch.arange(n, device=dev).repeat_interleave(ss)

    big = 1e30
    depth_map = torch.full((w * h + 1,), big, dtype=torch.float32, device=dev)
    depth_map.scatter_reduce_(0, flat_pix, flat_depth, "amin")
    # deterministic tie-break: among entries whose depth equals the pixel
    # minimum, keep the smallest point index
    is_win = flat_depth <= depth_map[flat_pix]
    cand = torch.where(is_win & m, flat_idx, n)
    idx_map = torch.full((w * h + 1,), n, dtype=torch.int64, device=dev)
    idx_map.scatter_reduce_(0, flat_pix, cand, "amin")
    idx_map = torch.where(idx_map >= n, -1, idx_map)[: w * h]
    if exact:
        seen = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
            0, idx_map.clamp(min=0), (idx_map >= 0).to(torch.int32),
            "amax").to(torch.bool)
        # the cast truncates toward zero before the clip, as astype(int32)
        xc = torch.clamp(x_proj.to(torch.int32), 0, w - 1).to(torch.int64)
        yc = torch.clamp(y_proj.to(torch.int32), 0, h - 1).to(torch.int64)
        pix = torch.where(seen & valid, xc * h + yc, w * h)
        idx_map = torch.full((w * h + 1,), -1, dtype=torch.int64, device=dev)
        idx_map.scatter_reduce_(0, pix, torch.arange(n, device=dev), "amax")
        idx_map = idx_map[: w * h]
    return idx_map.to(torch.int32).reshape(w, h)


def normalize_depth(dist, r_min=0.5, r_max=30.0):
    """Rescale distances by the camera range (visibility.py:1503-1518)."""
    return (dist - r_min) / (r_max + 1e-4)


def orientation_to_normal(view_dir_unit, normals):
    """|cos| of the angle between the viewing ray and the surface normal
    (visibility.py:1521-1545)."""
    return torch.abs(torch.sum(view_dir_unit * normals, dim=1))


def postprocess_features(
    xyz_to_img, y_proj, dist, linearity, planarity, scattering, normals,
    img_height, r_min=0.5, r_max=30.0,
):
    """The 6 projection-time viewing-condition features, fixed order
    (SURVEY.md §A.3; visibility.py:1548-1582): normalized depth, linearity,
    planarity, scattering, orientation-to-surface, normalized pixel height."""
    view_dir = xyz_to_img / (dist[:, None] + 1e-4)
    feats = [
        normalize_depth(dist, r_min, r_max),
        linearity,
        planarity,
        scattering,
        orientation_to_normal(view_dir, normals),
        y_proj / img_height,
    ]
    return torch.stack(feats, dim=1).to(torch.float32)


def _features(cam, xyz, y_proj, dist, geo):
    return postprocess_features(
        xyz - cam.center(xyz.device), y_proj, dist, geo["linearity"],
        geo["planarity"], geo["scattering"], geo["normal"],
        img_height=cam.size[1], r_min=cam.r_min, r_max=cam.r_max,
    )


def splat_zbuffer(camera: _cam.Camera, xyz, voxel=0.1, k_swell=1.0,
                  d_swell=1000.0, exact=False, max_splat=8, geo=None):
    """Full splatting visibility for one camera.

    Returns ``(idx_map int32 [W, H], depth_map float32 [W, H], x_proj,
    y_proj, depth, valid[, feats6])`` on ``xyz``'s device — dense maps hold
    -1 where no point is visible.  Pass ``geo`` (linearity / planarity /
    scattering / normal tensors) to also get the 6 projection-time view
    features of every point."""
    xyz = xyz.to(torch.float32)
    x_proj, y_proj, dist, valid = _cam.project(xyz, camera)
    bbox = splat_bboxes(camera, xyz, x_proj, y_proj, dist, voxel=voxel,
                        k_swell=k_swell, d_swell=d_swell)
    idx_map = _zbuffer(x_proj, y_proj, dist, valid, bbox, camera.size,
                       int(max_splat), bool(exact))
    # the winner's depth: the pixel's least depth (a tie's winner has it
    # too), or the centre-mapped point's in exact mode, as the JAX
    # package's depth map holds
    depth_map = torch.where(idx_map >= 0, dist[idx_map.clamp(min=0).long()],
                            -1.0)
    out = (idx_map, depth_map, x_proj, y_proj, dist, valid)
    if geo is None:
        return out
    return out + (_features(camera, xyz, y_proj, dist, geo),)


def splat_zbuffer_batch(cameras, xyz, voxel=0.1, k_swell=1.0, d_swell=1000.0,
                        exact=False, max_splat=8, geo=None):
    """Splatting visibility for a camera family.

    Returns ``(idx_maps int32 [C, W, H], feats6 [C, N, 6] or None)`` on
    ``xyz``'s device; ``geo`` holds the per-point linearity / planarity /
    scattering / normal tensors that the viewing features need; ``exact``
    keeps one centre pixel per seen point (the S3DIS preprocess's
    ``exact_splatting``).
    """
    idx_maps, feats = [], []
    for cam in cameras:
        out = splat_zbuffer(cam, xyz, voxel=voxel, k_swell=k_swell,
                            d_swell=d_swell, exact=exact,
                            max_splat=max_splat, geo=geo)
        idx_maps.append(out[0])
        if geo is not None:
            feats.append(out[6])
    return (torch.stack(idx_maps),
            torch.stack(feats) if geo is not None else None)


def project_features(camera: _cam.Camera, xyz, geo=None):
    """Projection + FOV cull (+ the 6 viewing-condition features) without a
    visibility model — the shared front half of the non-splatting methods
    (DepthBasedVisibility / BiasuttiVisibility, visibility.py:1779,1790).
    Returns ``(x_proj, y_proj, depth, valid, feats6 or None)``."""
    xyz = xyz.to(torch.float32)
    x_proj, y_proj, dist, valid = _cam.project(xyz, camera)
    feats6 = (_features(camera, xyz, y_proj, dist, geo)
              if geo is not None else None)
    return x_proj, y_proj, dist, valid, feats6


def _pixel_index(v, size: int):
    """``clip(v.astype(int32), 0, size - 1)`` of the JAX package, with its
    saturating cast: the clip comes first in float (NaN reads 0)."""
    v = torch.nan_to_num(v, nan=0.0)
    return torch.clamp(v, 0, size - 1).to(torch.int64)


def depth_map_visibility(x_proj, y_proj, dist, depth_map,
                         depth_threshold=0.05):
    """Visibility by comparison against a provided sensor depth map
    ``[W, H]`` (S3DIS 16-bit PNG path, visibility.py:1360-1388): a point is
    seen if ``|depth_map[x, y] - dist| <= depth_threshold`` (ABSOLUTE
    meters, the reference's rule); empty pixels hold a negative sentinel and
    can never pass for positive distances."""
    if not isinstance(depth_map, torch.Tensor):
        depth_map = torch.from_numpy(np.array(depth_map, np.float32))
    depth_map = depth_map.to(device=dist.device, dtype=torch.float32)
    w, h = depth_map.shape
    d_ref = depth_map[_pixel_index(x_proj, w), _pixel_index(y_proj, h)]
    return torch.abs(d_ref - dist) <= depth_threshold


def biasutti_visibility(x_proj, y_proj, dist, valid, k: int = 75,
                        threshold=None, x_margin=None, x_width=None):
    """Image-space kNN visibility (Biasutti et al.; reference
    ``visibility_biasutti`` visibility.py:1464-1500): a point is visible when
    ``alpha = exp(-((d - d_min)/(d_max - d_min))^2)`` over its k nearest
    *projected* neighbours is ``>= threshold`` (default: the mean alpha, the
    reference's rule) — no splatting, no z-buffer.  The kNN is
    :func:`deepviewagg_tpu_torch.ops.knn.knn` on the points' device.

    ``x_margin``/``x_width`` enable the reference's X-wrapped neighbour
    search for equirectangular panoramas (``k_nn_image_system``,
    visibility.py:1395-1460): points within ``x_margin`` pixels of either
    border also appear shifted by ±``x_width`` in the search set.

    Returns a bool mask over points (invalid points stay False and never
    appear as neighbours)."""
    from ..ops.knn import knn

    x_proj = x_proj.to(torch.float32)
    y_proj = y_proj.to(torch.float32)
    dist = dist.to(torch.float32)
    valid = valid.to(torch.bool)
    pix = torch.stack([x_proj, y_proj], dim=1)
    wrap = (x_margin is not None and x_margin > 0
            and x_width is not None and x_width > 0)
    if wrap:
        off = torch.tensor([[float(x_width), 0.0]], device=pix.device)
        search = torch.cat([pix, pix + off, pix - off])
        search_valid = torch.cat([
            valid,
            valid & (x_proj <= x_margin),
            valid & (x_proj >= x_width - x_margin),
        ])
        nbr_dist_src = torch.cat([dist] * 3)
    else:
        search, search_valid, nbr_dist_src = pix, valid, dist
    d2, idx = knn(pix, search, k=k, valid=search_valid)
    nbr_depth = nbr_dist_src[idx]
    # rows with fewer than k valid candidates get filler indices (their d2
    # is the 1e30 sentinel): those neighbours stay out of the depth range
    ok = d2 < 1e29
    d_min = torch.where(ok, nbr_depth, math.inf).amin(dim=1)
    d_max = torch.where(ok, nbr_depth, -math.inf).amax(dim=1)
    span_ok = torch.isfinite(d_min) & torch.isfinite(d_max)
    alpha = torch.exp(-(((dist - d_min)
                         / torch.clamp(d_max - d_min, min=1e-12)) ** 2))
    alpha = torch.where(valid & span_ok, alpha, math.nan)
    if threshold is None:
        n_valid = torch.clamp(valid.sum(), min=1)
        threshold = torch.nansum(torch.where(valid, alpha, 0.0)) / n_valid
    return valid & span_ok & (alpha >= threshold)
