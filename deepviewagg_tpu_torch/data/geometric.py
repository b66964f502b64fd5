"""Pointwise PCA geometric features: linearity / planarity / scattering / normals.

The port of ``deepviewagg_tpu/data/geometric.py`` (the reference's
``PCAComputePointwise`` + ``EigenFeatures``, core/data_transform/
features.py:360,488): one exact kNN (blockwise brute force on the request's
device, or the host's grid kNN past 100,000 points) and a closed-form
batched 3x3 eigensolver on the request's device.

Feature definitions (Demantke et al., eigenvalues l1 >= l2 >= l3,
sqrt-scaled): linearity = (sl1 - sl2) / sl1, planarity = (sl2 - sl3) / sl1,
scattering = sl3 / sl1; normal = eigenvector of the smallest eigenvalue,
oriented +z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import knn as _knn

__all__ = ["eigen_features", "pca_features"]

HOST_KNN_POINTS = 100_000


def sym3x3_eigvals(cov):
    """Closed-form (Cardano) eigenvalues of symmetric 3x3 batches [N,3,3],
    descending ``[N, 3]``."""
    a00, a11, a22 = cov[:, 0, 0], cov[:, 1, 1], cov[:, 2, 2]
    a01, a02, a12 = cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-20)
    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    isotropic = p2 <= 1e-24
    e1 = torch.where(isotropic, q, e1)
    e2 = torch.where(isotropic, q, e2)
    e3 = torch.where(isotropic, q, e3)
    return torch.clamp(torch.stack([e1, e2, e3], dim=1), min=0.0)


def sym3x3_eigvec(cov, lam):
    """Eigenvector of symmetric 3x3 batches for eigenvalue ``lam [N]``: the
    largest cross product of rows of (A - lam I); degenerate -> +z."""
    a = cov - lam[:, None, None] * torch.eye(3, device=cov.device)[None]
    c01 = torch.linalg.cross(a[:, 0], a[:, 1])
    c02 = torch.linalg.cross(a[:, 0], a[:, 2])
    c12 = torch.linalg.cross(a[:, 1], a[:, 2])
    n01 = torch.sum(c01**2, dim=1)
    n02 = torch.sum(c02**2, dim=1)
    n12 = torch.sum(c12**2, dim=1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[:, None], c01,
        torch.where((n02 >= n12)[:, None], c02, c12),
    )
    norm = torch.linalg.norm(best, dim=1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], device=cov.device).expand_as(best)
    return torch.where(norm > 1e-12, best / torch.clamp(norm, min=1e-20),
                       fallback)


def _eigen_from_neighborhoods(pts, nbr_idx):
    """pts [N,3], nbr_idx [N,k] -> (eigvals [N,3] desc, normal [N,3])."""
    nbrs = pts[nbr_idx]                          # [N, k, 3]
    c = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c) / nbrs.shape[1]
    eigvals = sym3x3_eigvals(cov)
    normal = sym3x3_eigvec(cov, eigvals[:, 2])   # smallest-eigenvalue vector
    # orient +z like the reference (features.py:568)
    flip = torch.where(normal[:, 2:3] < 0, -1.0, 1.0)
    return eigvals, normal * flip


def eigen_features(eigvals):
    """(linearity, planarity, scattering) from descending eigenvalues [N,3]."""
    s = torch.sqrt(eigvals.to(torch.float32))
    s1 = torch.clamp(s[:, 0], min=1e-8)
    return torch.stack([(s[:, 0] - s[:, 1]) / s1, (s[:, 1] - s[:, 2]) / s1,
                        s[:, 2] / s1], dim=1)


def pca_features(pos, k: int = 50, r_search=None, block: int = 1024,
                 pad_multiple: int = 2048, device="cuda"):
    """Per-point geometric features, computed on ``device``.

    Returns a dict ``{linearity, planarity, scattering [N], normal [N,3],
    nn_idx [N,k]}`` of tensors on ``device``.  ``r_search`` caps the
    neighborhood radius the way ``PCAComputePointwise(r=...)`` does:
    neighbors beyond it are replaced by the point itself.  Up to
    ``HOST_KNN_POINTS`` points the neighbours come from the brute-force kNN
    on ``device``, over inputs padded to ``pad_multiple`` with far-away
    masked points; past it from the host's grid kNN
    (:func:`~deepviewagg_tpu_torch.ops.knn.knn_grid`) on the unpadded cloud,
    as the JAX package does.  The eigensolver runs on ``device``.
    """
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    if n > HOST_KNN_POINTS:
        # the brute force is O(N^2): past this size the host's exact grid
        # kNN takes over, as in the JAX package
        d2, idx = _knn.knn_grid(pos, pos, k=k)
        pos_t = torch.as_tensor(pos, device=device)
        d2 = torch.as_tensor(d2, device=device)
        idx = torch.as_tensor(idx, device=device).to(torch.int64)
    else:
        n_pad = max(-(-n // pad_multiple) * pad_multiple, pad_multiple)
        pos_p = np.full((n_pad, 3), 1e6, np.float32)
        pos_p[:n] = pos
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        pos_t = torch.as_tensor(pos_p, device=device)
        d2, idx = _knn.knn(pos_t, pos_t, k=k,
                           valid=torch.as_tensor(valid, device=device),
                           block=block)
        pos_t, d2, idx = pos_t[:n], d2[:n], idx[:n]
    if r_search is not None:
        own = torch.arange(n, device=idx.device)[:, None]
        idx = torch.where(d2 <= r_search * r_search, idx, own)
    eigvals, normal = _eigen_from_neighborhoods(pos_t, idx)
    lin_plan_scat = eigen_features(eigvals)
    return {
        "linearity": lin_plan_scat[:, 0],
        "planarity": lin_plan_scat[:, 1],
        "scattering": lin_plan_scat[:, 2],
        "normal": normal.to(torch.float32),
        "nn_idx": idx,
    }
