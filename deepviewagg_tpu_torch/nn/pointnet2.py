"""PointNet++-style set-abstraction backbone (static-shape, batched).

The port of ``deepviewagg_tpu/nn/pointnet2.py`` (the reference's
modules/pointnet2, consumed by models/segmentation/pointnet2.py): a compact
SA (sample + group + pointwise-MLP + max) / FP (kNN-interpolate + MLP)
encoder-decoder over the padded point batch.

  * FPS / ball query / interpolation are :mod:`..ops.spatial`, run host-side
    per batch (on CPU tensors) into index tables, as the JAX package builds
    them, so the forward is gathers and matmuls;
  * samples never mix: grouping runs on per-sample-offset coordinates
    (:func:`_separated`, the JAX package's float32 shift of ``1e4`` per
    sample, kept as it is: ROADMAP C);
  * the groups' rows are taken by ``index_select`` on the flattened ``[M*k]``
    index, whose backward is an ``index_add_``, not the sorting
    ``index_put_`` that ``x[group]`` differentiates through.

Use :func:`build_pointnet_graph` at collate time, then
:class:`PointNet2Seg`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import spatial as sp
from .norm import MaskedBatchNorm

__all__ = ["build_pointnet_graph", "PointNet2Seg", "set_abstraction",
           "grouped_rows", "interpolate_up", "fp_decoder", "decode",
           "graph_levels"]


def _separated(pos, batch_idx, gap=1e4):
    """Shift each sample far apart so neighbour ops never cross samples."""
    return np.asarray(pos, np.float32) + np.asarray(batch_idx)[:, None] * gap


def build_pointnet_graph(
    pos: np.ndarray,
    batch_idx: np.ndarray,
    valid: np.ndarray,
    n_points: Sequence[int] = (4096, 1024, 256, 64),
    radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
    k: int = 32,
    self_k: int = 0,
) -> Dict:
    """Host-side: FPS centres, ball-query groups and upsampling kNN per SA
    level, as a dict of numpy index tables (``batch_to_torch`` moves it).

    ``self_k > 0`` also stores per-level SAME-level neighbour tables among
    the centres (``self_group`` / ``self_count``)."""
    sep = _separated(pos, batch_idx)
    levels: List[Dict] = []
    cur_pos, cur_valid = sep, np.asarray(valid, bool)
    for m, r in zip(n_points, radii):
        m = min(m, len(cur_pos))
        centers = sp.farthest_point_sample(cur_pos, m, cur_valid).numpy()
        cpos = cur_pos[centers]
        group, counts = sp.ball_query(cpos, cur_pos, r, k, valid=cur_valid)
        levels.append({
            "centers": centers.astype(np.int32),
            "group": group.numpy(),
            "group_count": counts.numpy().astype(np.int32),
            "center_valid": cur_valid[centers],
        })
        if self_k:
            sg, sc = sp.ball_query(cpos, cpos, r * 2, self_k,
                                   valid=cur_valid[centers])
            levels[-1]["self_group"] = sg.numpy()
            levels[-1]["self_count"] = sc.numpy().astype(np.int32)
        cur_pos = cpos
        cur_valid = cur_valid[centers]
    # FP: interpolation indices from level l+1 -> l (and level 0 -> input)
    all_pos = [sep]
    for lvl in levels:
        all_pos.append(all_pos[-1][lvl["centers"]])
    for i, lvl in enumerate(levels):
        d2, idx = sp.knn(torch.from_numpy(all_pos[i]),
                         torch.from_numpy(all_pos[i + 1]), k=3)
        lvl["up_idx"] = idx.numpy().astype(np.int32)
        lvl["up_d2"] = d2.numpy().astype(np.float32)
    return {"levels": levels, "pos": all_pos}


class _PointMLP(nn.Module):
    """Bias-free ``Dense_<j>`` + ``MaskedBatchNorm_<j>`` + ReLU per width
    (the flax ``_PointMLP``'s names)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 device=None):
        super().__init__()
        self.depth = len(channels)
        for j, c in enumerate(channels):
            setattr(self, f"Dense_{j}", nn.Linear(in_channels, c, bias=False,
                                                  device=device))
            setattr(self, f"MaskedBatchNorm_{j}", MaskedBatchNorm(
                c, device=device))
            in_channels = c
        self.out_channels = in_channels

    def forward(self, x, valid):
        for j in range(self.depth):
            x = getattr(self, f"Dense_{j}")(x)
            x = F.relu(getattr(self, f"MaskedBatchNorm_{j}")(x, valid))
        return x


def grouped_rows(x: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """``x[group]`` (``[M, k, C]``) by ``index_select`` on the flattened
    index: its backward accumulates with ``index_add_``."""
    m, k = group.shape
    return x.index_select(0, group.reshape(-1)).reshape(m, k, x.shape[-1])


def interpolate_up(x: torch.Tensor, up_idx: torch.Tensor,
                   up_d2: torch.Tensor) -> torch.Tensor:
    """The coarse rows ``x`` at the finer level: inverse squared-distance
    weights over the ``up_idx`` neighbours (the FP upsampling of the pointnet
    graph's ``up_idx`` / ``up_d2``)."""
    w = 1.0 / torch.clamp(up_d2, min=1e-10)
    w = w / torch.sum(w, dim=1, keepdim=True)
    return torch.sum(grouped_rows(x, up_idx) * w[..., None], dim=1)


def graph_levels(graph: Dict, n_levels: int) -> List[Dict]:
    """The graph's levels, which must be as many as the model's widths (the
    JAX modules zip them with their widths and then walk every level)."""
    levels = graph["levels"]
    if len(levels) != n_levels:
        raise ValueError(f"the graph has {len(levels)} levels, the model "
                         f"{n_levels} widths")
    return levels


def fp_decoder(module: nn.Module, skip_widths: Sequence[int], width: int,
               out_widths: Sequence[int], dense_first: int = 0,
               norm_first: int = 0, momentum: float = 0.9,
               device=None) -> int:
    """Give ``module`` the FP stages of a graph backbone under the flax
    names: ``Dense_<dense_first + j>`` (bias-free) and
    ``MaskedBatchNorm_<norm_first + j>`` for the ``j``-th stage from the
    coarsest level down.  ``skip_widths[li]`` is the width of level ``li``'s
    skip (level 0: the input features), ``width`` the encoder's output
    width, ``out_widths[li]`` the stage's output at level ``li``.  Returns
    the last stage's width."""
    for j, li in enumerate(reversed(range(len(out_widths)))):
        setattr(module, f"Dense_{dense_first + j}", nn.Linear(
            width + skip_widths[li], out_widths[li], bias=False,
            device=device))
        setattr(module, f"MaskedBatchNorm_{norm_first + j}", MaskedBatchNorm(
            out_widths[li], momentum=momentum, device=device))
        width = out_widths[li]
    return width


def decode(module: nn.Module, x, skips, levels, dense_first: int = 0,
           norm_first: int = 0, act=F.relu) -> torch.Tensor:
    """Run the stages of :func:`fp_decoder`: per level from the coarsest,
    ``x`` upsampled by the level's ``up_idx`` / ``up_d2``, concatenated with
    the skip, dense, masked batch norm over the skip's valid rows, ``act``.
    ``skips[li]`` is ``(features, valid)`` at level ``li``."""
    for j, li in enumerate(reversed(range(len(levels)))):
        fine_x, fine_valid = skips[li]
        up = interpolate_up(x, levels[li]["up_idx"], levels[li]["up_d2"])
        x = getattr(module, f"Dense_{dense_first + j}")(
            torch.cat([up, fine_x], -1))
        x = act(getattr(module, f"MaskedBatchNorm_{norm_first + j}")(
            x, fine_valid))
    return x


def set_abstraction(mlp: _PointMLP, x, src_pos, dst_pos, group, count,
                    center_valid) -> torch.Tensor:
    """One SA level: the relative positions and features of each centre's
    group through ``mlp``, max over the ``max(count, 1)`` first slots,
    invalid centres 0.  ``dst_pos`` are the centres' positions (the queries
    of ``group``)."""
    m, k = group.shape
    rel = grouped_rows(src_pos, group) - dst_pos[:, None, :]
    g = torch.cat([rel, grouped_rows(x, group)], dim=-1)
    h = mlp(g.reshape(m * k, -1),
            center_valid.repeat_interleave(k)).reshape(m, k, -1)
    slot = torch.arange(k, device=group.device)[None, :]
    ok = slot < torch.clamp(count[:, None], min=1)
    x = torch.amax(torch.where(ok[..., None], h, -1e30), dim=1)
    return torch.where(center_valid[:, None], x, 0.0)


class PointNet2Seg(nn.Module):
    """SA / FP segmentation net over a precomputed pointnet graph (the flax
    names: ``_PointMLP_<i>`` for the SA levels, then the FP levels from the
    coarsest, then ``head``).  ``forward(batch)`` returns ``{"logits"}``."""

    def __init__(self, num_classes: int, in_channels: int,
                 sa_channels: Sequence[Sequence[int]] = (
                     (32, 32, 64), (64, 64, 128), (128, 128, 256),
                     (256, 256, 512)),
                 fp_channels: Sequence[Sequence[int]] = (
                     (128, 128), (256, 128), (256, 256), (256, 256)),
                 device="cuda", seed=0):
        super().__init__()
        self.n_levels = n = len(sa_channels)
        widths = [in_channels]
        for li in range(n):
            mlp = _PointMLP(3 + widths[-1], sa_channels[li], device=device)
            setattr(self, f"_PointMLP_{li}", mlp)
            widths.append(mlp.out_channels)
        c = widths[-1]
        for j, li in enumerate(reversed(range(n))):
            mlp = _PointMLP(c + widths[li], fp_channels[li], device=device)
            setattr(self, f"_PointMLP_{n + j}", mlp)
            c = mlp.out_channels
        self.head = nn.Linear(c, num_classes, device=device)
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        graph = batch["pn_graph"]
        levels = graph["levels"]
        pos = [p.to(torch.float32) for p in graph["pos"]]
        x = batch["feats"]
        valid = (batch["graph"]["levels"][0]["valid"] if "graph" in batch
                 else batch["valid"])
        skips = [(x, valid)]
        for li, lvl in enumerate(levels):
            x = set_abstraction(getattr(self, f"_PointMLP_{li}"), x, pos[li],
                                pos[li + 1], lvl["group"],
                                lvl["group_count"], lvl["center_valid"])
            skips.append((x, lvl["center_valid"]))
        # FP path: coarse -> fine
        n = self.n_levels
        for j, li in enumerate(reversed(range(n))):
            fine_x, fine_valid = skips[li]
            up = interpolate_up(x, levels[li]["up_idx"], levels[li]["up_d2"])
            x = torch.cat([up, fine_x], dim=-1)
            x = getattr(self, f"_PointMLP_{n + j}")(x, fine_valid)
        return {"logits": self.head(x)}
