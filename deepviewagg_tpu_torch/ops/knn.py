"""Blockwise brute-force exact k-nearest-neighbors on the request's device.

The port of ``deepviewagg_tpu/ops/knn.py``: :func:`knn`, one tiled ``topk``
over distance blocks (``|x-y|^2 = |x|^2 + |y|^2 - 2 x.y``, one matmul per
block), the role pykeops / FAISS / torch_cluster play in the reference's
preprocessing; :func:`radius_count`, the ball-query census; and
:func:`dilated_knn`, a random ``k`` of the ``k * dilation`` nearest (the
reference's DilatedKNNNeighbourFinder), drawn from a numpy ``Generator`` as
the JAX package draws it.  Exact (no ANN); neighbors at exactly equal
distance may come out in another order than the JAX package's
``lax.top_k``.  :func:`knn_grid` is the host's exact grid kNN for
preprocessing at scale (the native builder, ``deepviewagg_tpu_torch/native``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native

__all__ = ["knn", "knn_grid", "radius_count", "dilated_knn"]


def knn(query: torch.Tensor, points: torch.Tensor, k: int, valid=None,
        block: int = 1024):
    """Exact kNN: returns ``(sq_dists [Nq, k], idx int64 [Nq, k])`` on the
    inputs' device.  ``valid`` masks padding points out of the candidates
    (their distance reads 1e30 if a row has fewer than ``k`` valid ones)."""
    query = query.to(torch.float32)
    points = points.to(torch.float32)
    big = 1e30
    pts_sq = torch.sum(points * points, dim=1)
    if valid is not None:
        pts_sq = torch.where(valid, pts_sq, big)
    dists, idx = [], []
    for start in range(0, query.shape[0], block):
        q = query[start:start + block]
        d = torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ points.T) + pts_sq[None, :]
        # the expanded form goes slightly negative for near-duplicates
        d = torch.clamp(d, min=0.0)
        if valid is not None:
            d = torch.where(valid[None, :], d, big)
        dv, di = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dists.append(dv)
        idx.append(di)
    return torch.cat(dists), torch.cat(idx)


def knn_grid(query, points, k: int, cell: float = None):
    """Exact kNN on the host over native grid-cell lists: ``(d2 float32
    [Nq, k] ascending, idx int32 [Nq, k])`` as numpy, O(N * candidates)
    instead of the brute force's O(N^2) (the role of the reference's KDTree /
    FAISS in preprocessing, features.py:360).  Distances are direct
    differences, so they round otherwise than :func:`knn`'s expanded form.
    The search stops 16 rings of cells out (``native/kernelmap.cpp``): a
    neighbour beyond is missed, a short neighbourhood repeats its nearest,
    and a query with none raises.

    ``cell``: cube edge in position units; by default sized so that the
    query's first ring holds a few ``k`` candidates.  Empty ``points`` go to
    :func:`knn` on the CPU, as the JAX package's fallback does."""
    points = np.ascontiguousarray(points, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    if len(points) == 0:
        d2, idx = knn(torch.from_numpy(query), torch.from_numpy(points), k)
        return d2.numpy(), idx.to(torch.int32).numpy()
    if cell is None:
        lo, hi = points.min(0), points.max(0)
        vol = float(np.prod(np.maximum(hi - lo, 1e-3)))
        # ~k/4 points per cell -> the 27-cell first ring holds ~7k candidates
        cell = max((vol * max(k, 4) / (4.0 * len(points))) ** (1.0 / 3.0),
                   1e-4)
    return _native.knn_grid(points, query, int(k), float(cell))


def radius_count(query: torch.Tensor, points: torch.Tensor, radius: float,
                 valid=None, block: int = 1024) -> torch.Tensor:
    """Number of (valid) points within ``radius`` of each query, int64
    ``[Nq]`` on the inputs' device: the expanded squared distance, not
    clamped, against ``radius ** 2``, as the JAX package counts."""
    query = query.to(torch.float32)
    points = points.to(torch.float32)
    pts_sq = torch.sum(points * points, dim=1)
    r2 = radius * radius
    out = []
    for start in range(0, query.shape[0], block):
        q = query[start:start + block]
        d = (torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ points.T)
             + pts_sq[None, :])
        inside = d <= r2
        if valid is not None:
            inside = inside & valid[None, :]
        out.append(torch.sum(inside, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=query.device)
    return torch.cat(out)


def dilated_knn(query: torch.Tensor, points: torch.Tensor, k: int,
                dilation: int, valid=None, rng=None, block: int = 1024):
    """Dilated kNN: the ``k * dilation`` nearest neighbors, of which a random
    ``k`` per query are kept, without replacement (a cheap receptive-field
    expansion).  ``rng`` is a numpy ``Generator`` and is required when
    ``dilation > 1``: a seeded default would pick the same subset on every
    call.  The pick is ``argpartition`` of ``rng.random`` keys per row, the
    JAX package's, so one ``Generator`` state gives both packages the same
    subset.  ``dilation <= 1`` is :func:`knn`."""
    if dilation <= 1:
        return knn(query, points, k, valid=valid, block=block)
    if rng is None:
        raise ValueError(
            "dilated_knn with dilation > 1 needs an explicit numpy Generator "
            "rng: pass the dataset's or epoch's rng so that the k-of-"
            "k*dilation subsample varies across calls")
    d, i = knn(query, points, k * dilation, valid=valid, block=block)
    keys = rng.random((i.shape[0], k * dilation))
    pick = torch.from_numpy(np.argpartition(keys, k - 1, axis=1)[:, :k]).to(
        i.device)
    return torch.gather(d, 1, pick), torch.gather(i, 1, pick)
