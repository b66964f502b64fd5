"""Point-cloud registration: siamese descriptors + Kabsch alignment.

The port of ``deepviewagg_tpu/models/registration.py`` (the reference's
registration task stack, datasets/registration 3DMatch etc. + FCGF-style
models): a shared sparse encoder produces per-point descriptors for two
fragments; mutual-nearest-neighbour correspondences feed a closed-form
weighted Kabsch / Procrustes solve.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.res16unet import RES16_PRESETS, Res16UNet

__all__ = ["RegistrationNet", "kabsch", "mutual_nearest",
           "hardest_contrastive"]


class RegistrationNet(nn.Module):
    """Shared sparse UNet -> L2-normalised per-point descriptors (the flax
    names ``backbone``, ``desc``).  ``forward(batch)`` returns the
    descriptors ``[cap, descriptor_dim]``."""

    def __init__(self, descriptor_dim: int = 32, backbone: str = "Res16UNet14",
                 in_channels: int = 1, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.backbone = Res16UNet(in_channels, *RES16_PRESETS[backbone],
                                  device=device)
        self.desc = nn.Linear(self.backbone.out_channels, descriptor_dim,
                              device=device)
        if seed is not None:
            from .segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> torch.Tensor:
        d = self.desc(self.backbone(batch["feats"], batch["graph"]))
        # rsqrt(sum + eps): unlike norm(), differentiable at the all-zero
        # rows padding produces
        return d * torch.rsqrt(torch.sum(d * d, dim=1, keepdim=True) + 1e-12)


def mutual_nearest(desc_a, desc_b, valid_a=None, valid_b=None):
    """Mutual nearest neighbours in descriptor space ->
    ``(idx_a [M], idx_b [M], mask [M])`` with ``M = len(desc_a)``."""
    sim = desc_a @ desc_b.T
    if valid_b is not None:
        sim = torch.where(valid_b[None, :], sim, -1e9)
    if valid_a is not None:
        sim = torch.where(valid_a[:, None], sim, -1e9)
    ab = torch.argmax(sim, dim=1)
    ba = torch.argmax(sim, dim=0)
    idx_a = torch.arange(desc_a.shape[0], device=desc_a.device)
    mutual = ba.index_select(0, ab) == idx_a
    if valid_a is not None:
        mutual = mutual & valid_a
    return idx_a, ab, mutual


def kabsch(src, dst, weights=None):
    """Closed-form rigid alignment: ``(R, t)`` minimising
    ``||R src + t - dst||^2``.  (``R`` and ``t`` do not depend on the SVD's
    sign conventions, which differ between backends.)"""
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    if weights is None:
        weights = torch.ones(src.shape[0], device=src.device)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=src.device)
    w = weights / torch.clamp(weights.sum(), min=1e-8)
    mu_s = (src * w[:, None]).sum(dim=0)
    mu_d = (dst * w[:, None]).sum(dim=0)
    h = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    s = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = vt.T @ s @ u.T
    return r, mu_d - r @ mu_s


def hardest_contrastive(desc_a, desc_b, pos_pairs, margin_pos=0.1,
                        margin_neg=1.4, num_neg: int = 256, valid_b=None):
    """FCGF-style hardest-contrastive loss over known positive pairs
    ``pos_pairs [P, 2]`` (the same physical point in both fragments).  Pass
    ``valid_b`` so that cap-padding rows (all-zero descriptors, distance
    about 1 from any unit vector) never become the 'hardest' negatives."""
    def safe_norm(x, dim):
        # eps inside the sqrt: d/dx ||0|| is NaN otherwise (identical pairs)
        return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)

    pos_pairs = pos_pairs.to(torch.int64)
    da = desc_a.index_select(0, pos_pairs[:, 0])
    db = desc_b.index_select(0, pos_pairs[:, 1])
    pos_d = safe_norm(da - db, 1)
    # hardest negatives among a subsample (as many as there are rows)
    sub = desc_b[:num_neg]
    n_sub = sub.shape[0]
    d_an = safe_norm(da[:, None] - sub[None], -1)
    if valid_b is not None:
        d_an = torch.where(valid_b[:num_neg][None, :], d_an, 1e9)
    # mask out the true positive column when inside the subsample
    col = pos_pairs[:, 1]
    own = torch.arange(n_sub, device=col.device)[None, :] == col[:, None]
    d_an = torch.where(own & (col < num_neg)[:, None], 1e9, d_an)
    neg_d = torch.amin(d_an, dim=1)
    loss_pos = torch.clamp(pos_d - margin_pos, min=0.0) ** 2
    loss_neg = torch.clamp(margin_neg - neg_d, min=0.0) ** 2
    return torch.mean(loss_pos) + torch.mean(loss_neg)
