"""The mapping factory: posed images + point cloud -> MultiViewMapping.

The port of the splatting path of ``deepviewagg_tpu/data/mapping_factory.py``
(the reference's ``MapImages`` -> ``SplattingVisibility`` ->
``ImageMapping.from_dense`` -> ``NeighborhoodBasedMappingFeatures``,
core/data_transform/multimodal/image.py:162-612).  The kNN, the PCA
features and the per-camera z-buffers run on ``device``; the ragged ->
array compression is numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import cameras as _cam
from ..core import visibility as _vis
from ..ops import knn as _knn
from . import geometric as _geo
from .mapping import NUM_VIEW_FEATURES, MultiViewMapping

__all__ = ["build_mappings", "VisibilityParams"]


class VisibilityParams:
    """Visibility knobs of the reference's ``SplattingVisibility``
    (visibility.py:1764): voxel, k_swell, d_swell, exact, plus the static
    ``max_splat`` grid and the kNN size of the density/occlusion features.
    Only ``method='splatting'`` is ported."""

    def __init__(self, voxel=0.05, k_swell=1.0, d_swell=1000.0, exact=False,
                 max_splat=8, knn_k=16, method="splatting"):
        if method != "splatting":
            raise NotImplementedError(
                f"visibility method {method!r} is not ported yet")
        self.voxel = voxel
        self.k_swell = k_swell
        self.d_swell = d_swell
        self.exact = exact
        self.max_splat = max_splat
        self.knn_k = knn_k
        self.method = method


def _image_mappings_dense(idx_map: np.ndarray):
    """Extract (point, x, y) pixel triplets from a dense winner-index map."""
    xs, ys = np.nonzero(idx_map >= 0)
    pts = idx_map[xs, ys]
    return pts.astype(np.int64), xs.astype(np.int32), ys.astype(np.int32)


def build_mappings(
    pos: np.ndarray,
    cams: Sequence[_cam.Camera],
    params: Optional[VisibilityParams] = None,
    geometric: Optional[dict] = None,
    nn_idx=None,
    device="cuda",
) -> MultiViewMapping:
    """Build the full mapping for one sample (unpadded capacities); the
    geometric features, z-buffers and kNN run on ``device``.

    ``geometric`` optionally provides precomputed ``{linearity, planarity,
    scattering, normal}`` (tensors or arrays; else computed here by
    :func:`deepviewagg_tpu_torch.data.geometric.pca_features` with k = 50);
    ``nn_idx`` optionally reuses a SELF-INCLUSIVE kNN index table ``[N,
    >=knn_k]`` (column 0 = self) for the density / occlusion features, as
    the JAX package's signature does."""
    params = params or VisibilityParams()
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    if geometric is None:
        geometric = _geo.pca_features(pos, k=min(50, max(4, n - 1)),
                                      device=device)

    # pad points to a size bucket like the JAX package; pads sit beyond
    # r_max and are never valid
    pad_multiple = 2048
    n_pad = max(-(-n // pad_multiple) * pad_multiple, pad_multiple)
    pos_p = torch.full((n_pad, 3), 1e6, dtype=torch.float32, device=device)
    pos_p[:n] = torch.as_tensor(pos, device=device)

    def _padf(x):
        out = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=torch.float32,
                          device=device)
        out[:n] = x
        return out

    geo_dev = {key: _padf(torch.as_tensor(geometric[key], dtype=torch.float32,
                                          device=device))
               for key in ("linearity", "planarity", "scattering", "normal")}

    per_image = [None] * len(cams)
    seen_matrix = np.zeros((n, len(cams)), bool)
    # one splatting pass per camera family (same model, size, crops, range)
    families: dict = {}
    for i, cam in enumerate(cams):
        key = (cam.model, cam.size, cam.crop_top, cam.crop_bottom,
               float(cam.r_min), float(cam.r_max))
        families.setdefault(key, []).append(i)

    for ids in families.values():
        idx_maps_dev, feats6_dev = _vis.splat_zbuffer_batch(
            [cams[i] for i in ids], pos_p, voxel=params.voxel,
            k_swell=params.k_swell, d_swell=params.d_swell,
            exact=params.exact, max_splat=params.max_splat, geo=geo_dev,
        )
        idx_maps = idx_maps_dev.cpu().numpy()      # ONE [C, W, H] readback
        for j, i in enumerate(ids):
            pts, xs, ys = _image_mappings_dense(idx_maps[j])
            if len(pts) == 0:
                continue
            order = np.argsort(pts, kind="stable")
            pts, xs, ys = pts[order], xs[order], ys[order]
            upts, starts = np.unique(pts, return_index=True)
            seen_matrix[upts, i] = True
            # device-side row select before the readback
            feats6 = feats6_dev[j][torch.as_tensor(upts, device=device)]
            per_image[i] = dict(upts=upts, starts=starts, pts=pts, xs=xs,
                                ys=ys, feats6=feats6.cpu().numpy())

    # features 7-8: density (per point) and occlusion (per point, image) —
    # NeighborhoodBasedMappingFeatures (image.py:431-612) over a
    # self-inclusive kNN table: density uses the distance to column k-1
    # (image.py:533); occlusion counts seen neighbors over columns 0..k-1
    # plus a baseline 1 for the point itself, normalized by k+1
    # (image.py:586-600)
    k = min(params.knn_k, n)
    if nn_idx is not None and nn_idx.shape[1] >= k:
        if isinstance(nn_idx, torch.Tensor):
            nn_idx = nn_idx.cpu().numpy()
        nn_idx = np.asarray(nn_idx)[:, :k]
        diffs = pos[nn_idx[:, -1]] - pos
        d2_max = np.sum(diffs * diffs, axis=1)
    else:
        pos_t = torch.as_tensor(pos, device=device)
        d2, nn_idx = _knn.knn(pos_t, pos_t, k=k)
        d2_max = d2[:, -1].cpu().numpy()
        nn_idx = nn_idx.cpu().numpy()
    # ref: v_sphere = 3.1416 * d2_max; non-finite densities -> 1
    # (image.py:537-543, guarded like the JAX package)
    with np.errstate(divide="ignore", invalid="ignore"):
        density = ((k + 1) / (3.1416 * d2_max)) * (params.voxel ** 2)
    density = np.where(np.isfinite(density), density, 1.0).astype(np.float32)
    occlusion = (1.0 + seen_matrix[nn_idx].sum(axis=1)) / (k + 1)

    # assemble view & pixel tables, image-major then sorted by point
    v_pid, v_img, v_feats = [], [], []
    q_lists = []
    for i, d in enumerate(per_image):
        if d is None:
            continue
        m = len(d["upts"])
        feats = np.zeros((m, NUM_VIEW_FEATURES), np.float32)
        feats[:, :6] = d["feats6"]
        feats[:, 6] = density[d["upts"]]
        feats[:, 7] = occlusion[d["upts"], i]
        v_pid.append(d["upts"])
        v_img.append(np.full(m, i, np.int64))
        v_feats.append(feats)
        counts = np.diff(np.append(d["starts"], len(d["pts"])))
        q_lists.append((counts, d["xs"], d["ys"]))

    if not v_pid:
        return MultiViewMapping(
            point_id=np.zeros(0, np.int32), image_id=np.zeros(0, np.int32),
            view_feats=np.zeros((0, NUM_VIEW_FEATURES), np.float32),
            view_valid=np.zeros(0, bool), pix_view=np.zeros(0, np.int32),
            pix_x=np.zeros(0, np.int32), pix_y=np.zeros(0, np.int32),
            pix_valid=np.zeros(0, bool), num_points=n, num_images=len(cams),
        )

    v_pid = np.concatenate(v_pid)
    v_img = np.concatenate(v_img)
    v_feats = np.concatenate(v_feats)
    # views sorted by (point, image): stable sort on point keeps image order
    order = np.argsort(v_pid, kind="stable")

    counts_all = np.concatenate([c for c, _, _ in q_lists])
    xs_all = np.concatenate([x for _, x, _ in q_lists])
    ys_all = np.concatenate([y for _, _, y in q_lists])

    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    # new view index of each pixel = inv[old view index]
    pix_view_old = np.repeat(np.arange(len(counts_all)), counts_all)
    pix_view_new = inv[pix_view_old]
    pix_order = np.argsort(pix_view_new, kind="stable")

    out = MultiViewMapping(
        point_id=v_pid[order].astype(np.int32),
        image_id=v_img[order].astype(np.int32),
        view_feats=v_feats[order],
        view_valid=np.ones(len(order), bool),
        pix_view=pix_view_new[pix_order].astype(np.int32),
        pix_x=xs_all[pix_order],
        pix_y=ys_all[pix_order],
        pix_valid=np.ones(len(pix_order), bool),
        num_points=n,
        num_images=len(cams),
    )
    out.check()
    return out
