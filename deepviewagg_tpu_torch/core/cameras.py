"""Camera models on the request's device: the equirectangular panorama.

The port of ``deepviewagg_tpu/core/cameras.py`` for the
``s3dis_equirectangular`` model (the flagship's synthetic S3DIS-style
cameras).  Every function projects ALL points and returns a validity mask —
no point is dropped, so shapes stay fixed (visibility.py:58-630 of the
reference).

``x`` below is the image WIDTH coordinate and ``y`` the HEIGHT coordinate,
matching the reference's (x_pix, y_pix) ordering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

CAMERA_MODELS = ("s3dis_equirectangular",)


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
        """World-space camera center ``[3]`` on ``device``."""
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
    if camera.model != "s3dis_equirectangular":
        raise NotImplementedError(
            f"camera model {camera.model!r} is not ported yet")
    xyz = xyz.to(torch.float32)
    to_img = xyz - camera.center(xyz.device)
    dist = torch.linalg.norm(to_img, dim=1)
    in_range = (dist > camera.r_min) & (dist < camera.r_max)
    x, y, z = equirectangular_projection(to_img, dist, camera.opk, camera.size)
    fov = field_of_view_mask(
        x, y, z, camera.size, camera.crop_top, camera.crop_bottom, camera.mask
    )
    return x, y, dist, in_range & fov
