"""Spatial ops: FPS, ball query, grouping, kNN interpolation.

The port of ``deepviewagg_tpu/ops/spatial.py`` (the reference wraps
torch-points-kernels CUDA ops, core/spatial_ops/{sampling,neighbour_finder,
interpolate}.py).  Torch functions on the inputs' device:

  * :func:`farthest_point_sample` — iterative max-min selection (the classic
    FPS; exact, deterministic: the first maximum wins, as ``jnp.argmax``);
  * :func:`ball_query` — the ``k`` nearest neighbours by :func:`knn`, cut at
    the radius, torch-points-kernels semantics (missing neighbours repeat the
    first hit);
  * :func:`knn_interpolate` — inverse-distance weighted k-NN feature
    upsampling (``KNNInterpolate``, core/spatial_ops/interpolate.py:7).

Neighbours at exactly equal distance may come out in another order than the
JAX package's, as :func:`knn` says.  Arrays that are not tensors (numpy) are
taken on the CPU.
"""

from __future__ import annotations

import torch

from .knn import knn

__all__ = ["farthest_point_sample", "ball_query", "knn_interpolate",
           "multiscale_ball_query"]


def _tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t if dtype is None else t.to(dtype)


def farthest_point_sample(pos, n_samples: int, valid=None,
                          start: int = 0) -> torch.Tensor:
    """Indices of ``n_samples`` FPS-selected points (int32 ``[n_samples]``)
    on ``pos``'s device; invalid points are never selected (unless every
    remaining distance is below theirs, as in the JAX package: they read
    -1)."""
    pos = _tensor(pos, torch.float32)
    n = pos.shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=pos.device)
             if valid is None else _tensor(valid).to(pos.device, torch.bool))
    d2 = torch.where(valid, torch.tensor(1e30, device=pos.device),
                     torch.tensor(-1.0, device=pos.device))
    idx = torch.zeros(int(n_samples), dtype=torch.int64, device=pos.device)
    idx[0] = int(start)
    last = idx[:1]
    for i in range(1, int(n_samples)):
        # index_select, not pos[last]: no host synchronisation on the card
        diff = pos - pos.index_select(0, last)
        nd = torch.sum(diff * diff, dim=1)
        d2 = torch.minimum(d2, torch.where(valid, nd, -1.0))
        last = torch.argmax(d2).reshape(1)
        idx[i:i + 1] = last
    return idx.to(torch.int32)


def ball_query(query, points, radius: float, k: int, valid=None,
               block: int = 1024):
    """``(idx int32 [Nq, k], counts int32 [Nq])``: neighbour indices within
    ``radius``; rows with fewer than k hits repeat their first hit
    (torch-points-kernels convention); rows with zero hits hold their
    nearest point with ``count == 0``."""
    query = _tensor(query, torch.float32)
    points = _tensor(points, torch.float32)
    if valid is not None:
        valid = _tensor(valid).to(points.device, torch.bool)
    d2, idx = knn(query, points, k=k, valid=valid, block=block)
    within = d2 <= radius * radius
    counts = within.sum(dim=1).to(torch.int32)
    idx = torch.where(within, idx, idx[:, :1].expand_as(idx))
    return idx.to(torch.int32), counts


def knn_interpolate(feats, src_pos, dst_pos, k: int = 3, valid=None,
                    block: int = 1024) -> torch.Tensor:
    """Inverse-distance weighted k-NN upsampling ``[Nd, C]``: ``feats`` live
    at ``src_pos``, the output at ``dst_pos`` (the reference's decoder
    upsampling and full-res voting remap, ``KNNInterpolate``)."""
    feats = _tensor(feats)
    if valid is not None:
        valid = _tensor(valid).to(feats.device, torch.bool)
    d2, idx = knn(_tensor(dst_pos, torch.float32),
                  _tensor(src_pos, torch.float32), k=k, valid=valid,
                  block=block)
    w = 1.0 / torch.clamp(d2, min=1e-10)
    w = w / torch.sum(w, dim=1, keepdim=True)
    f = feats.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + feats.shape[1:])
    return torch.sum(f * w[..., None], dim=1)


def multiscale_ball_query(query, points, radii, ks, valid=None,
                          block: int = 1024):
    """One neighbour table per scale (ref MultiscaleRadiusNeighbourFinder,
    neighbour_finder.py:170): ``radii`` and ``ks`` are matched lists;
    returns ``[(idx [Nq, k_s], counts [Nq]), ...]``."""
    if not hasattr(radii, "__len__"):
        radii = [radii]
    if not hasattr(ks, "__len__"):
        ks = [ks] * len(radii)
    if len(radii) != len(ks):
        raise ValueError("radii/ks length mismatch")
    return [ball_query(query, points, r, k, valid=valid, block=block)
            for r, k in zip(radii, ks)]
