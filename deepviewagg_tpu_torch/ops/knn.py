"""Blockwise brute-force exact k-nearest-neighbors on the request's device.

The port of ``deepviewagg_tpu/ops/knn.py::knn``: one tiled ``topk`` over
distance blocks (``|x-y|^2 = |x|^2 + |y|^2 - 2 x.y``, one matmul per block),
the role pykeops / FAISS / torch_cluster play in the reference's
preprocessing.  Exact (no ANN); neighbors at exactly equal distance may come
out in another order than the JAX package's ``lax.top_k``.
"""

from __future__ import annotations

import torch

__all__ = ["knn"]


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
