"""Camera models on the request's device: equirectangular, pinhole and
MEI-fisheye projections.

The port of ``deepviewagg_tpu/core/cameras.py`` (the reference's
projection kernels, torch_points3d/core/multimodal/visibility.py:58-630).
Every function projects ALL points and returns a validity mask — no point
is dropped, so shapes stay fixed.

Conventions (SURVEY.md §A.1):
  * ``s3dis_equirectangular`` — camera position + omega/phi/kappa Euler
    triplet (visibility.py:151-216).
  * ``scannet`` — 4x4 cam->world pose, inverted to world->cam in float32
    (visibility.py:220-285), pinhole ``u = fx px/pz + mx``.
  * ``kitti360_perspective`` — 4x4 cam->world extrinsic, ``p = (x - T) R``
    then pinhole (visibility.py:238-247).
  * ``kitti360_fisheye`` — cam->world extrinsic + MEI model (xi, k1, k2,
    gamma1, gamma2, u0, v0): unit-sphere normalise, ``x / (z + xi)``,
    radial distortion ``1 + k1 r^2 + k2 r^4``, affine (visibility.py:289-339).

``x`` below is the image WIDTH coordinate and ``y`` the HEIGHT coordinate,
matching the reference's (x_pix, y_pix) ordering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

CAMERA_MODELS = (
    "s3dis_equirectangular",
    "scannet",
    "kitti360_perspective",
    "kitti360_fisheye",
)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static description of one posed camera (host numpy fields)."""

    model: str                      # one of CAMERA_MODELS
    size: tuple                     # (W, H) pixels
    pos: np.ndarray | None = None   # [3] camera center (world)
    opk: np.ndarray | None = None   # [3] omega,phi,kappa (equirectangular)
    extrinsic: np.ndarray | None = None  # [4,4]
    intrinsic: np.ndarray | None = None  # [4,4]-ish pinhole K
    fisheye: np.ndarray | None = None    # [7] xi,k1,k2,gamma1,gamma2,u0,v0
    crop_top: int = 0
    crop_bottom: int = 0
    r_min: float = 0.5
    r_max: float = 30.0
    mask: Optional[np.ndarray] = None    # [W, H] bool static-pixel mask

    def center(self, device) -> torch.Tensor:
        """World-space camera center ``[3]`` on ``device``: ``pos``, or the
        translation column of the cam->world extrinsic (pinhole and fisheye
        models; the reference reads ScanNet centres the same way,
        datasets/segmentation/multimodal/scannet.py:192)."""
        if self.pos is not None:
            return torch.as_tensor(np.asarray(self.pos, np.float32), device=device)
        e = torch.as_tensor(np.asarray(self.extrinsic, np.float32), device=device)
        return e[:3, 3]


def opk_to_rotation(opk: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from an omega/phi/kappa triplet (visibility.py:58-90)."""
    o, p, k = opk[0], opk[1], opk[2]
    one, zero = torch.ones_like(o), torch.zeros_like(o)
    co, so = torch.cos(o), torch.sin(o)
    cp, sp = torch.cos(p), torch.sin(p)
    ck, sk = torch.cos(k), torch.sin(k)
    m_o = torch.stack([one, zero, zero, zero, co, -so, zero, so, co]).reshape(3, 3)
    m_p = torch.stack([cp, zero, sp, zero, one, zero, -sp, zero, cp]).reshape(3, 3)
    m_k = torch.stack([ck, -sk, zero, sk, ck, zero, zero, zero, one]).reshape(3, 3)
    return m_o @ m_p @ m_k


def equirectangular_projection(xyz_to_img, radius, opk, size):
    """Project camera-centered points onto an equirectangular panorama.

    Returns float (x_pix, y_pix, ones); all rows valid by construction.
    """
    rot = opk_to_rotation(torch.as_tensor(
        np.asarray(opk, np.float32), device=xyz_to_img.device))
    v = xyz_to_img @ rot.T
    t = torch.atan2(v[:, 1], v[:, 0])
    p = torch.arccos(torch.clamp(v[:, 2] / torch.clamp(radius, min=1e-8),
                                 -1.0, 1.0))
    w, h = size
    x_pix = torch.nan_to_num(((w - 1) * (1 - t / math.pi) / 2) % w)
    y_pix = torch.nan_to_num(((h - 1) * p / math.pi) % h)
    return x_pix, y_pix, torch.ones_like(x_pix)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def pinhole_projection(xyz, extrinsic, intrinsic, model="scannet"):
    """Pinhole projection; returns ``(x_pix, y_pix, z_cam)``.  ``scannet``
    inverts the stored cam->world pose in float32, as ``jnp.linalg.inv``
    does in the JAX package (LAPACK on the CPU, cuSOLVER on the card: the
    float32 inverses need not share their last bits)."""
    e = _tensor(extrinsic, xyz.device)
    if model == "scannet":
        world_to_cam = torch.linalg.inv(e)
        r, t = world_to_cam[:3, :3], world_to_cam[:3, 3]
        p = xyz @ r.T + t
    elif model == "kitti360_perspective":
        r, t = e[:3, :3], e[:3, 3]
        p = (xyz - t) @ r
    else:
        raise ValueError(f"unknown pinhole model {model}")
    k = _tensor(intrinsic, xyz.device)
    z = p[:, 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    x = p[:, 0] * k[0, 0] / zs + k[0, 2]
    y = p[:, 1] * k[1, 1] / zs + k[1, 2]
    return x, y, z


def fisheye_projection(xyz, extrinsic, fisheye):
    """MEI-model fisheye projection (KITTI-360 cam2/cam3)."""
    e = _tensor(extrinsic, xyz.device)
    r, t = e[:3, :3], e[:3, 3]
    p = (xyz - t) @ r
    xi, k1, k2, g1, g2, u0, v0 = _tensor(fisheye, xyz.device)
    norm = torch.linalg.norm(p, dim=1)
    denom = norm + 1e-4
    x = p[:, 0] / denom
    y = p[:, 1] / denom
    z = p[:, 2] / denom
    x = x / (z + xi)
    y = y / (z + xi)
    r2 = x**2 + y**2
    r4 = r2**2
    d = 1 + k1 * r2 + k2 * r4
    x_pix = g1 * d * x + u0
    y_pix = g2 * d * y + v0
    z_out = norm * p[:, 2] / (torch.abs(p[:, 2]) + 1e-4)
    return x_pix, y_pix, z_out


def field_of_view_mask(x_pix, y_pix, z, size, crop_top=0, crop_bottom=0,
                       img_mask=None):
    """Validity mask: in image bounds, in crop band, in front of camera,
    and on unmasked (non-static) pixels (visibility.py:396-478)."""
    w, h = size
    ok = (
        (x_pix >= 0)
        & (x_pix < w)
        & (y_pix >= crop_top)
        & (y_pix < h - crop_bottom)
        & (z > 0)
    )
    if img_mask is not None:
        xi = torch.clamp(torch.floor(x_pix).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.floor(y_pix).to(torch.int64), 0, h - 1)
        mask = torch.as_tensor(np.asarray(img_mask, bool), device=x_pix.device)
        ok = ok & mask[xi, yi]
    return ok


def project(xyz: torch.Tensor, camera: Camera):
    """Project all points through ``camera``.

    Returns ``(x_pix, y_pix, depth, valid)`` — depth is the euclidean
    distance to the camera center; ``valid`` combines the r_min/r_max range
    gate and the field-of-view gate (visibility.py:480-630).
    """
    xyz = xyz.to(torch.float32)
    to_img = xyz - camera.center(xyz.device)
    dist = torch.linalg.norm(to_img, dim=1)
    in_range = (dist > camera.r_min) & (dist < camera.r_max)
    if camera.model == "s3dis_equirectangular":
        x, y, z = equirectangular_projection(to_img, dist, camera.opk,
                                             camera.size)
    elif camera.model in ("scannet", "kitti360_perspective"):
        x, y, z = pinhole_projection(xyz, camera.extrinsic, camera.intrinsic,
                                     model=camera.model)
    elif camera.model == "kitti360_fisheye":
        x, y, z = fisheye_projection(xyz, camera.extrinsic, camera.fisheye)
    else:
        raise ValueError(f"unknown camera model {camera.model}")
    fov = field_of_view_mask(
        x, y, z, camera.size, camera.crop_top, camera.crop_bottom, camera.mask
    )
    return x, y, dist, in_range & fov
