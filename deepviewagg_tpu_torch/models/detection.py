"""VoteNet-style 3D object detection (deep Hough voting).

The port of ``deepviewagg_tpu/models/detection.py`` (the reference's
VoteNet family, modules/VoteNet/ + the object_detection task stack): seed
points vote toward object centres, votes are clustered into proposals, and
a proposal head regresses objectness / centre / size / class (Qi et al.
2019), in the JAX package's static form:

  * seeds: the SA levels of the pointnet graph (host-built FPS / ball
    tables, :func:`..nn.pointnet2.build_pointnet_graph`);
  * votes: a per-seed MLP offset (bounded by tanh * max_offset);
  * proposals: clusters precomputed host-side on the *seed* positions
    (``det_clusters``), the JAX package's static stand-in for the
    reference's dynamic FPS on the votes;
  * losses: vote-to-nearest-GT-centre L1, objectness CE by proximity,
    centre / size regression on positive proposals.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.pointnet2 import _PointMLP, set_abstraction

__all__ = ["VoteNetDet", "votenet_loss"]


class VoteNetDet(nn.Module):
    """Backbone features -> votes -> seed-anchored proposals (the flax names:
    ``_PointMLP_<i>`` for the SA levels, the vote MLP, the proposal MLP and
    the head MLP in that order; ``vote_offset``, ``vote_feat``,
    ``objectness``, ``center``, ``size``, ``cls``).  ``forward(batch)``
    returns the JAX module's dict."""

    def __init__(self, num_classes: int, in_channels: int = 4,
                 max_offset: float = 1.5, vote_channels: int = 64,
                 sa_channels: Sequence[Sequence[int]] = ((32, 64), (64, 128)),
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.max_offset = max_offset
        self.n_levels = n = len(sa_channels)
        c = in_channels
        for li in range(n):
            mlp = _PointMLP(3 + c, sa_channels[li], device=device)
            setattr(self, f"_PointMLP_{li}", mlp)
            c = mlp.out_channels
        setattr(self, f"_PointMLP_{n}", _PointMLP(c, [vote_channels],
                                                  device=device))
        self.vote_offset = nn.Linear(vote_channels, 3, device=device)
        self.vote_feat = nn.Linear(vote_channels, c, device=device)
        setattr(self, f"_PointMLP_{n + 1}", _PointMLP(3 + c, [128, 128],
                                                      device=device))
        setattr(self, f"_PointMLP_{n + 2}", _PointMLP(128, [128],
                                                      device=device))
        self.objectness = nn.Linear(128, 2, device=device)
        self.center = nn.Linear(128, 3, device=device)
        self.size = nn.Linear(128, 3, device=device)
        self.cls = nn.Linear(128, num_classes, device=device)
        if seed is not None:
            from .segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        graph = batch["pn_graph"]
        levels = graph["levels"]
        pos = [p.to(torch.float32) for p in graph["pos"]]
        x = batch["feats"]
        valid = batch["valid"]
        # --- encoder to the seed level (last SA level) --------------------
        for li, lvl in enumerate(levels):
            x = set_abstraction(getattr(self, f"_PointMLP_{li}"), x, pos[li],
                                pos[li + 1], lvl["group"],
                                lvl["group_count"], lvl["center_valid"])
            valid = lvl["center_valid"]
        n = self.n_levels
        seed_pos, seed_valid = pos[len(levels)], valid

        # --- voting --------------------------------------------------------
        v = getattr(self, f"_PointMLP_{n}")(x, seed_valid)
        offset = torch.tanh(self.vote_offset(v)) * self.max_offset
        vote_pos = seed_pos + offset
        vote_feat = x + self.vote_feat(v)

        # --- proposals: seed-anchored clusters -----------------------------
        cl = batch["det_clusters"]
        anchor = vote_pos.index_select(0, cl["centers"])
        agg = set_abstraction(getattr(self, f"_PointMLP_{n + 1}"), vote_feat,
                              vote_pos, anchor, cl["group"],
                              cl["group_count"], cl["center_valid"])
        head = getattr(self, f"_PointMLP_{n + 2}")(agg, cl["center_valid"])
        center = anchor + torch.tanh(self.center(head)) * self.max_offset
        size = F.softplus(self.size(head)) + 1e-3
        return {
            "vote_pos": vote_pos, "seed_pos": seed_pos,
            "seed_valid": seed_valid,
            "objectness": self.objectness(head), "center": center,
            "size": size, "cls_logits": self.cls(head),
            "proposal_valid": cl["center_valid"],
        }


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx)


def votenet_loss(out: Dict, gt_boxes, gt_classes=None,
                 near_thresh: float = 0.6, far_thresh: float = 1.2):
    """Compact VoteNet loss: vote L1 + objectness CE + centre / size L1
    (+ class CE).  ``gt_boxes [B, 6]`` centre + size; padded rows size <= 0.
    Returns ``(total, {"vote", "obj", "box"})``."""
    dev = out["center"].device
    gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32, device=dev)
    gt_ok = gt_boxes[:, 3:].amin(dim=1) > 0
    centers = gt_boxes[:, :3]
    big = 1e6

    def nearest(p):
        d = torch.linalg.vector_norm(p[:, None, :] - centers[None], dim=-1)
        d = torch.where(gt_ok[None, :], d, big)
        # argmin: the first of equal distances, as jnp.argmin
        return torch.argmin(d, dim=1), torch.amin(d, dim=1)

    def masked_mean(values, mask):
        return torch.sum(torch.where(mask, values, 0.0)) / torch.clamp(
            mask.sum(), min=1)

    # vote regression: only seeds INSIDE a GT box vote to its centre
    # (VoteNet's on-object seed selection)
    j_seed, _ = nearest(out["seed_pos"])
    seed_c = _rows(centers, j_seed)
    inside = torch.all(torch.abs(out["seed_pos"] - seed_c)
                       <= _rows(gt_boxes, j_seed)[:, 3:] / 2 + 0.1, dim=1)
    vote_mask = out["seed_valid"] & inside & _rows(gt_ok, j_seed)
    vote_loss = masked_mean(torch.abs(out["vote_pos"] - seed_c).sum(dim=1),
                            vote_mask)

    # proposals
    jp, dp = nearest(out["center"])
    pos_mask = out["proposal_valid"] & (dp < near_thresh)
    neg_mask = out["proposal_valid"] & (dp > far_thresh)
    obj_target = pos_mask.to(torch.int64)
    logp = torch.log_softmax(out["objectness"], dim=-1)
    obj_nll = -torch.gather(logp, 1, obj_target[:, None])[:, 0]
    obj_loss = masked_mean(obj_nll, pos_mask | neg_mask)

    center_l1 = torch.abs(out["center"] - _rows(centers, jp)).sum(dim=1)
    size_l1 = torch.abs(out["size"] - _rows(gt_boxes, jp)[:, 3:]).sum(dim=1)
    box_loss = masked_mean(center_l1 + size_l1, pos_mask)

    total = vote_loss + obj_loss + box_loss
    if gt_classes is not None:
        cls_lp = torch.log_softmax(out["cls_logits"], dim=-1)
        tgt = _rows(torch.as_tensor(gt_classes, device=dev).to(torch.int64),
                    jp)
        cls_nll = -torch.gather(cls_lp, 1, tgt[:, None])[:, 0]
        total = total + masked_mean(cls_nll, pos_mask)
    return total, {"vote": vote_loss, "obj": obj_loss, "box": box_loss}
