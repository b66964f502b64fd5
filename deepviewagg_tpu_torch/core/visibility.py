"""Occlusion-aware visibility by splat z-buffering, on the request's device.

The port of the splatting path of ``deepviewagg_tpu/core/visibility.py``
(the reference's array formulation, torch_points3d/core/multimodal/
visibility.py:1198-1285): every point gets a fixed ``max_splat x max_splat``
pixel grid, pixels outside its splat bbox are masked, and the z-buffer is
two masked scatter-min passes over a dense ``W*H`` map — a depth race, then
a deterministic smallest-index tie-break.  ``scatter_reduce_("amin")`` gives
the same answer in any order, so the maps are reproducible on the card too.
Exact splatting then re-maps each winning point to its centre pixel, again
by an order-free reduction.

Splat-size model (visibility.py:647-875): angular width
``(1 + k_swell * exp(-dist / ln(d_swell))) * voxel / dist``, converted to
pixels; the equirectangular x-width divides by ``sin(pi * y / H)``.
"""

from __future__ import annotations

import math

import torch

from . import cameras as _cam

__all__ = ["splat_bboxes", "splat_zbuffer_batch", "postprocess_features"]


def _clamp_bbox(x_a, x_b, y_a, y_b, size, crop_top, crop_bottom):
    w, h = size
    x_a = torch.clamp(x_a, 0, w - 1)
    x_b = torch.clamp(x_b, 1, w)
    y_a = torch.clamp(y_a, crop_top, h - crop_bottom - 1)
    y_b = torch.clamp(y_b, crop_top + 1, h - crop_bottom)
    return x_a, x_b, y_a, y_b


def splat_bboxes(camera: _cam.Camera, xyz, x_proj, y_proj, dist,
                 voxel=0.1, k_swell=1.0, d_swell=1000.0):
    """Per-point splat bbox (x_a, x_b, y_a, y_b) in pixels, int32."""
    if camera.model != "s3dis_equirectangular":
        raise NotImplementedError(
            f"camera model {camera.model!r} is not ported yet")
    w, h = camera.size
    swell = 1.0 + k_swell * torch.exp(-dist / math.log(d_swell))
    angular_width = swell * voxel / torch.clamp(dist, min=1e-6)
    width_y = angular_width * h / math.pi
    a = angular_width * w / (2.0 * math.pi)
    width_x = a / (torch.sin((math.pi / h) * y_proj) + 0.001)

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
        torch.abs(torch.sum(view_dir * normals, dim=1)),
        y_proj / img_height,
    ]
    return torch.stack(feats, dim=1).to(torch.float32)


def splat_zbuffer_batch(cameras, xyz, voxel=0.1, k_swell=1.0, d_swell=1000.0,
                        exact=False, max_splat=8, geo=None):
    """Splatting visibility for a camera family.

    Returns ``(idx_maps int32 [C, W, H], feats6 [C, N, 6] or None)`` on
    ``xyz``'s device; ``geo`` holds the per-point linearity / planarity /
    scattering / normal tensors that the viewing features need; ``exact``
    keeps one centre pixel per seen point (the S3DIS preprocess's
    ``exact_splatting``).
    """
    xyz = xyz.to(torch.float32)
    idx_maps, feats = [], []
    for cam in cameras:
        x_proj, y_proj, dist, valid = _cam.project(xyz, cam)
        bbox = splat_bboxes(cam, xyz, x_proj, y_proj, dist, voxel=voxel,
                            k_swell=k_swell, d_swell=d_swell)
        idx_maps.append(_zbuffer(x_proj, y_proj, dist, valid, bbox, cam.size,
                                 int(max_splat), bool(exact)))
        if geo is not None:
            feats.append(postprocess_features(
                xyz - cam.center(xyz.device), y_proj, dist,
                geo["linearity"], geo["planarity"], geo["scattering"],
                geo["normal"], img_height=cam.size[1], r_min=cam.r_min,
                r_max=cam.r_max,
            ))
    return (torch.stack(idx_maps),
            torch.stack(feats) if geo is not None else None)
