"""Plain PointNet (Qi et al. 2016): classification and segmentation heads.

The port of ``deepviewagg_tpu/nn/pointnet.py`` (the reference's
``modules/PointNet/modules.py``: STN3D input / feature transforms, shared
MLPs, global max pool; ``models/segmentation/pointnet.py``).  The batch is
the collate contract (concatenated padded rows, level-0 ``batch_idx`` /
``valid`` in ``batch["graph"]``); the T-Nets' and the global descriptor's
max pools are masked segment maxima over ``batch_idx`` through
:func:`deepviewagg_tpu_torch.ops.segment.segment_reduce`, so on the card
they launch the sorted-segment kernel ``csrc/segment_csr.cu`` (and its
backward) or raise: three launches forward and three backward per train
step.  Float32 throughout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.branch import soft_dropout
from ..ops import segment as seg
from .norm import MaskedBatchNorm

__all__ = ["TNet", "PointNetEncoder", "PointNetCls", "PointNetSeg"]

DROPOUT = 0.3


def _mlp(owner: nn.Module, in_channels: int, channels: Sequence[int],
         first: int = 0, device=None) -> int:
    """Give ``owner`` a shared MLP under the flax names: bias-free
    ``Dense_<first + j>`` + ``MaskedBatchNorm_<first + j>`` per width (ReLU
    after each, in :func:`_run_mlp`).  Returns the output width."""
    for j, c in enumerate(channels):
        setattr(owner, f"Dense_{first + j}", nn.Linear(
            in_channels, c, bias=False, device=device))
        setattr(owner, f"MaskedBatchNorm_{first + j}", MaskedBatchNorm(
            c, device=device))
        in_channels = c
    return in_channels


def _run_mlp(owner: nn.Module, x, valid, first: int, depth: int):
    for j in range(first, first + depth):
        x = getattr(owner, f"Dense_{j}")(x)
        x = F.relu(getattr(owner, f"MaskedBatchNorm_{j}")(x, valid))
    return x


def _global_max(h, batch_idx, valid, num_batches: int):
    """Per-sample masked max ``[num_batches, C]`` (the padding rows' segment
    ``num_batches`` dropped)."""
    return seg.segment_reduce(h, batch_idx, num_batches + 1, "max",
                              valid)[:num_batches]


def _per_row(t: torch.Tensor, batch_idx: torch.Tensor) -> torch.Tensor:
    """``t[batch_idx]`` with the index clamped into ``t``, as a JAX gather
    clamps the padding rows' ``batch_idx == num_batches``."""
    return t.index_select(0, torch.clamp(batch_idx, 0, t.shape[0] - 1))


class TNet(nn.Module):
    """Spatial / feature transform net (STN3D): shared MLP -> global max ->
    FC -> ``[B, d, d]`` transform at identity for zero weights.  The flax
    names: ``Dense_0..2`` / ``MaskedBatchNorm_0..2`` (64, 128, 1024),
    ``Dense_3`` / ``Dense_4`` (512, 256, with bias), ``Dense_5`` (``d * d``,
    zero-initialised)."""

    def __init__(self, in_channels: int, dim: int, num_batches: int,
                 device=None):
        super().__init__()
        self.dim, self.num_batches = dim, num_batches
        c = _mlp(self, in_channels, (64, 128, 1024), device=device)
        self.Dense_3 = nn.Linear(c, 512, device=device)
        self.Dense_4 = nn.Linear(512, 256, device=device)
        self.Dense_5 = nn.Linear(256, dim * dim, device=device)

    def zero_last(self) -> None:
        """flax's ``zeros`` initializers of ``Dense_5``."""
        with torch.no_grad():
            self.Dense_5.weight.zero_()
            self.Dense_5.bias.zero_()

    def forward(self, x, batch_idx, valid):
        h = _run_mlp(self, x, valid, 0, 3)
        g = _global_max(h, batch_idx, valid, self.num_batches)
        g = F.relu(self.Dense_4(F.relu(self.Dense_3(g))))
        d = self.dim
        eye = torch.eye(d, dtype=g.dtype, device=g.device)
        return self.Dense_5(g).reshape(-1, d, d) + eye[None]


class PointNetEncoder(nn.Module):
    """Shared-MLP trunk -> per-point features + global descriptor (the flax
    names: ``stn3``, ``Dense_<j>`` / ``MaskedBatchNorm_<j>`` local then
    global, ``stnf``).  ``in_channels`` counts the 3 coordinates and the
    features."""

    def __init__(self, in_channels: int, num_batches: int,
                 local_channels: Sequence[int] = (64, 64),
                 global_channels: Sequence[int] = (64, 128, 1024),
                 input_transform: bool = True, feature_transform: bool = True,
                 device=None):
        super().__init__()
        self.num_batches = num_batches
        self.n_local, self.n_global = len(local_channels), len(global_channels)
        if input_transform:
            self.stn3 = TNet(in_channels, 3, num_batches, device=device)
        c = _mlp(self, in_channels, local_channels, device=device)
        if feature_transform:
            self.stnf = TNet(c, c, num_batches, device=device)
        self.out_channels = _mlp(self, c, global_channels,
                                 first=self.n_local, device=device)
        self.local_channels = c

    def forward(self, pos, feats, batch_idx, valid):
        x = torch.cat([pos, feats], dim=-1) if feats is not None else pos
        if hasattr(self, "stn3"):
            t = self.stn3(x, batch_idx, valid)
            pos = torch.einsum("nd,nde->ne", pos, _per_row(t, batch_idx))
            x = torch.cat([pos, feats], dim=-1) if feats is not None else pos
        x = _run_mlp(self, x, valid, 0, self.n_local)
        if hasattr(self, "stnf"):
            t = self.stnf(x, batch_idx, valid)
            x = torch.einsum("nd,nde->ne", x, _per_row(t, batch_idx))
        local = x
        x = _run_mlp(self, x, valid, self.n_local, self.n_global)
        return local, _global_max(x, batch_idx, valid, self.num_batches)


def _init(model: nn.Module, seed) -> None:
    """Seeded init, then the T-Nets' last layers zeroed as flax does."""
    if seed is None:
        return
    from ..models.segmentation import init_parameters

    init_parameters(model, torch.Generator().manual_seed(seed))
    for m in model.modules():
        if isinstance(m, TNet):
            m.zero_last()


def _points(batch: Dict) -> tuple:
    lvl = batch["graph"]["levels"][0]
    pos = batch["pos"] if "pos" in batch else batch["feats"][:, :3]
    return pos, lvl["batch_idx"], lvl["valid"]


class PointNetCls(nn.Module):
    """Classification head: global descriptor -> ``Dense_0`` (512) ->
    ``Dense_1`` (256) -> Dropout(0.3) -> ``head``.  ``in_channels`` is the
    width of ``batch["feats"]``.

    ``forward(batch, generator=None)`` returns ``{"logits" [num_batches,
    num_classes]}``; the dropout is drawn from ``generator`` in training
    mode only, and only when one is given, as flax's ``has_rng("dropout")``
    gates it."""

    def __init__(self, num_classes: int, in_channels: int,
                 num_batches: int = 1, device="cuda", seed=0):
        super().__init__()
        self.encoder = PointNetEncoder(3 + in_channels, num_batches,
                                       device=device)
        self.Dense_0 = nn.Linear(self.encoder.out_channels, 512,
                                 device=device)
        self.Dense_1 = nn.Linear(512, 256, device=device)
        self.head = nn.Linear(256, num_classes, device=device)
        _init(self, seed)

    def forward(self, batch: Dict,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        pos, batch_idx, valid = _points(batch)
        _, g = self.encoder(pos, batch["feats"], batch_idx, valid)
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(g))))
        if self.training:
            h = soft_dropout(h, DROPOUT, generator)
        return {"logits": self.head(h)}


class PointNetSeg(nn.Module):
    """Segmentation head: per-point locals concatenated with the broadcast
    global descriptor -> ``Dense_<j>`` / ``MaskedBatchNorm_<j>`` (512, 256,
    128) -> ``head``.  ``in_channels`` is the width of ``batch["feats"]``;
    ``forward(batch)`` returns ``{"logits" [N, num_classes]}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 num_batches: int = 1, device="cuda", seed=0):
        super().__init__()
        self.num_batches = num_batches
        self.encoder = PointNetEncoder(3 + in_channels, num_batches,
                                       device=device)
        c = _mlp(self, self.encoder.local_channels
                 + self.encoder.out_channels, (512, 256, 128), device=device)
        self.head = nn.Linear(c, num_classes, device=device)
        _init(self, seed)

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        pos, batch_idx, valid = _points(batch)
        local, g = self.encoder(pos, batch["feats"], batch_idx, valid)
        # padding rows (batch_idx == num_batches) read a zero descriptor
        pad_g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        x = torch.cat([local, _per_row(pad_g, batch_idx)], dim=-1)
        x = _run_mlp(self, x, valid, 0, 3)
        return {"logits": self.head(x)}
