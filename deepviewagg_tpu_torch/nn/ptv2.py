"""Point Transformer V2 (PT-v2m2 base) for semantic segmentation.

The model of Wu, Lao, Jiang, Liu and Zhao, "Point Transformer V2: Grouped
Vector Attention and Partition-based Pooling" (NeurIPS 2022,
arXiv:2210.05666), as Pointcept's ``point_transformer_v2m2_base.py`` builds
it, over the batches of the ``"ptv2"`` collate route (positions, features,
labels and per-sample offsets; nothing else is built on the host):

* patch embedding (``stem``): ``ReLU(BN(Linear(x)))`` (no bias), then a
  block sequence at level 0;
* a block sequence: one neighbour table for its level (the ``k`` nearest
  points of each point in its own sample, itself first,
  :func:`..ops.knn.knn_points`), then its blocks;
* a block: ``x = ReLU(x + DropPath(BN(Linear(ReLU(BN(Attn(ReLU(BN(
  Linear(x))))))))))``, both linears without bias;
* grouped vector attention with ``G`` groups: ``q = ReLU(BN(Linear(x)))``,
  ``k = ReLU(BN(Linear(x)))``, ``v = Linear(x)``; ``k`` and ``v`` taken at
  the neighbours, a missing neighbour (-1) giving a zero row and a zero
  relative position (``pointops.grouping`` multiplies the relative
  positions by ``sign(idx + 1)``); ``peb = Linear(ReLU(BN(Linear(p_j -
  p_i))))``; ``w = softmax_j(Linear(ReLU(BN(Linear(k_j - q_i + peb, G)))),
  G))`` times the mask ``sign(idx + 1)``; ``out = sum_j (v_j + peb) * w``,
  ``C / G`` channels a group;
* grid pooling: ``ReLU(BN(Linear(x)))`` (no bias), then each sample's
  points clustered by the cells of the stage's grid measured from the
  sample's minimum corner, the cluster's maximum of features
  (``ops.segment.segment_csr``) and mean of positions (summed in float64,
  so that the sum is the same in any order: a float32 sum's rounding could
  move a mean across a cell edge of the next pooling);
* unpooling (``map``): ``ReLU(BN(Linear(x)))[cluster] +
  ReLU(BN(Linear(skip)))``;
* head ``Linear(48, 48), BN, ReLU, Linear(48, classes)``.

BatchNorm is :class:`.norm.PointBatchNorm` (over the ``N x S`` rows of the
neighbour tensors).  Only the batch's real points enter the net: the
level-0 rows past the sample sizes (the collate's padding) are cut off
first and get zero logits, so that they enter no statistic, table or
cluster.  A pooled level's size is data-dependent: each pooling reads its
per-sample cluster counts once to the host (one synchronisation), which
also gives the neighbour counters below their values.  An encoder stage
and the decoder stage of its level share one table (the search is exact),
and level 0's table of 8 for the patch embedding is the first 8 columns of
its table of 16.

DropPath draws one keep mask a point (timm's DropPath on the ``[N, C]``
features), rates ``linspace(0, drop_path)`` over the encoder's blocks and
over the decoder's (stage 0 first), none in the patch embedding, from the
step's generator; with none (eval) nothing is dropped.

Precision: ``compute_dtype`` (bfloat16 on the card) rounds the operands of
the linear layers of the blocks, attention, pooling and unpooling, whose
outputs come out in it too; the softmax over neighbours, BatchNorm
statistics, the residual stream, pooling, head, loss and parameters stay
float32.  Pointcept trains under float16 autocast.

Traced (``utils/trace.py``), device spans ``ptv2.knn`` (a table's cell
keys, sort and search), ``ptv2.knn.core`` (the search kernel alone),
``ptv2.attention`` (q, k and v through the weighted sum), ``ptv2.pool``
and ``ptv2.unpool``; counters ``ptv2.neighbour_slots`` (rows x k through
each attention) and ``ptv2.missing_slots`` (those slots given the zero
row).

``record``: a list that, while set, receives each forward's level sizes
(``("level", level, [points a sample])``), neighbour tables (``("knn",
level, int32 [n, k])``) and DropPath masks (``("keep", block name, bool
[n])``), on the host, for a reference to replay and compare.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from ..ops.knn import knn_points
from ..utils import trace
from .norm import PointBatchNorm

__all__ = ["PTv2Config", "PTV2_PRESETS", "GroupedVectorAttention", "Block",
           "BlockSequence", "GridPool", "UnpoolWithSkip", "GVAPatchEmbed",
           "PointTransformerV2Seg", "drop_path_rates", "grid_clusters"]

# bits of a pooling key: the sample above three 16-bit cell coordinates
_AXIS_BITS = 16


@dataclasses.dataclass(frozen=True)
class PTv2Config:
    """The widths of a PTv2 (Pointcept's ``PT-v2m2`` arguments); the
    attention has query, key and value biases, a positional bias and no
    positional multiplier, and no attention dropout."""

    patch_embed_depth: int = 1
    patch_embed_channels: int = 48
    patch_embed_groups: int = 6
    patch_embed_neighbours: int = 8
    enc_depths: Tuple[int, ...] = (2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (96, 192, 384, 512)
    enc_groups: Tuple[int, ...] = (12, 24, 48, 64)
    enc_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    dec_depths: Tuple[int, ...] = (1, 1, 1, 1)
    dec_channels: Tuple[int, ...] = (48, 96, 192, 384)
    dec_groups: Tuple[int, ...] = (6, 12, 24, 48)
    dec_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    grid_sizes: Tuple[float, ...] = (0.06, 0.15, 0.375, 0.9375)
    qkv_bias: bool = True
    drop_path: float = 0.3


PTV2_PRESETS = {
    # the published base model (S3DIS semseg-pt-v2m2-0-base)
    "PTv2-m2-base": PTv2Config(),
    # a narrow two-stage net for CPU smokes and tests
    "PTv2Test": PTv2Config(patch_embed_channels=8, patch_embed_groups=2,
                           patch_embed_neighbours=4, enc_depths=(1, 2),
                           enc_channels=(16, 24), enc_groups=(4, 6),
                           enc_neighbours=(8, 8), dec_depths=(1, 1),
                           dec_channels=(8, 16), dec_groups=(2, 4),
                           dec_neighbours=(8, 8), grid_sizes=(0.3, 1.2)),
}


def drop_path_rates(cfg: PTv2Config):
    """``(encoder rates per stage, decoder rates per stage)``:
    ``linspace(0, drop_path)`` over each, in stage order."""
    def split(depths):
        rates = torch.linspace(0, cfg.drop_path, sum(depths)).tolist()
        out, at = [], 0
        for d in depths:
            out.append(rates[at:at + d])
            at += d
        return out

    return split(cfg.enc_depths), split(cfg.dec_depths)


def _linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``mod(x)`` with operands rounded to ``dtype``, out in ``dtype``."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), b)


class _Level:
    """One level's points in a forward: positions, per-sample counts (host)
    and offsets, each row's sample, and its neighbour tables by ``k``."""

    def __init__(self, lvl: int, pos: torch.Tensor, counts: List[int],
                 offsets: torch.Tensor, sample: torch.Tensor, k_max: int,
                 record: Optional[list]):
        self.lvl, self.pos, self.counts = lvl, pos, counts
        self.n = int(sum(counts))
        self.offsets, self.sample = offsets, sample
        self.k_max = k_max
        self.record = record
        self._knn: Optional[torch.Tensor] = None
        self._tables: Dict[int, tuple] = {}

    def table(self, k: int):
        """``(idx int64 [n, k] (the zero row n where missing), mask f32
        [n, k], rel f32 [n, k, 3])`` of the ``k`` nearest."""
        if k in self._tables:
            return self._tables[k]
        if self._knn is None:
            with trace.span("ptv2.knn", device=self.pos):
                self._knn = knn_points(self.pos, self.offsets, self.k_max,
                                       sample=self.sample)
            if self.record is not None:
                self.record.append(("knn", self.lvl, self._knn.cpu()))
        idx = self._knn[:, :k]
        missing = idx < 0
        z = torch.where(missing, self.n, idx.to(torch.int64))
        mask = (~missing).to(torch.float32)
        pos = torch.cat([self.pos, self.pos.new_zeros(1, 3)])
        rel = (pos[z] - self.pos[:, None, :]) * mask[..., None]
        self._tables[k] = (z, mask, rel)
        return self._tables[k]

    def missing_slots(self, k: int) -> int:
        return sum(c * max(0, k - c) for c in self.counts)


class GroupedVectorAttention(nn.Module):
    """Grouped vector attention over a neighbour table."""

    def __init__(self, channels: int, groups: int, qkv_bias: bool = True,
                 device=None):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{channels} channels in {groups} groups")
        self.groups = groups
        self.q = nn.Linear(channels, channels, bias=qkv_bias, device=device)
        self.q_norm = PointBatchNorm(channels, device=device)
        self.k = nn.Linear(channels, channels, bias=qkv_bias, device=device)
        self.k_norm = PointBatchNorm(channels, device=device)
        self.v = nn.Linear(channels, channels, bias=qkv_bias, device=device)
        self.pe1 = nn.Linear(3, channels, device=device)
        self.pe_norm = PointBatchNorm(channels, device=device)
        self.pe2 = nn.Linear(channels, channels, device=device)
        self.we1 = nn.Linear(channels, groups, device=device)
        self.we_norm = PointBatchNorm(groups, device=device)
        self.we2 = nn.Linear(groups, groups, device=device)

    def forward(self, x: torch.Tensor, table, dtype) -> torch.Tensor:
        idx, mask, rel = table
        n, s = idx.shape
        c = x.shape[1]
        flat = idx.reshape(-1)
        q = F.relu(self.q_norm(_linear(self.q, x, dtype), torch.float32))
        k = F.relu(self.k_norm(_linear(self.k, x, dtype), torch.float32))
        v = _linear(self.v, x, dtype)
        kj = torch.cat([k, k.new_zeros(1, c)]).index_select(0, flat)
        vj = torch.cat([v, v.new_zeros(1, c)]).index_select(0, flat)
        pe = F.relu(self.pe_norm(_linear(self.pe1, rel, dtype)))
        peb = _linear(self.pe2, pe, dtype)
        r = kj.view(n, s, c) - q[:, None, :] + peb
        w = F.relu(self.we_norm(_linear(self.we1, r, dtype)))
        w = _linear(self.we2, w, dtype).float()
        w = torch.softmax(w, dim=1) * mask[..., None]
        value = (vj.view(n, s, c).float() + peb).view(
            n, s, self.groups, c // self.groups)
        return (value * w[..., None]).sum(1).reshape(n, c)


class Block(nn.Module):
    """Linear, BN, ReLU, attention, BN, ReLU, Linear, BN, DropPath, the
    residual and ReLU."""

    def __init__(self, channels: int, groups: int, drop_path: float,
                 qkv_bias: bool = True, device=None):
        super().__init__()
        self.drop_path = drop_path
        self.fc1 = nn.Linear(channels, channels, bias=False, device=device)
        self.norm1 = PointBatchNorm(channels, device=device)
        self.attn = GroupedVectorAttention(channels, groups, qkv_bias,
                                           device=device)
        self.norm2 = PointBatchNorm(channels, device=device)
        self.fc3 = nn.Linear(channels, channels, bias=False, device=device)
        self.norm3 = PointBatchNorm(channels, device=device)
        self.name = ""

    def _drop(self, y, generator, record):
        if self.drop_path <= 0.0 or generator is None:
            return y
        keep = torch.rand(y.shape[0], generator=generator,
                          device=generator.device) >= self.drop_path
        if record is not None:
            record.append(("keep", self.name, keep))
        if y.is_cuda:
            # from page-locked memory: the host does not wait for the card
            keep = keep.pin_memory().to(y.device, non_blocking=True)
        else:
            keep = keep.to(y.device)
        return torch.where(keep[:, None], y / (1.0 - self.drop_path), 0.0)

    def forward(self, x, level: _Level, k: int, dtype, generator=None,
                record=None):
        f32 = torch.float32
        h = F.relu(self.norm1(_linear(self.fc1, x, dtype), f32))
        table = level.table(k)
        trace.count("ptv2.neighbour_slots", level.n * k)
        trace.count("ptv2.missing_slots", level.missing_slots(k))
        with trace.span("ptv2.attention", device=x):
            h = self.attn(h, table, dtype)
        h = F.relu(self.norm2(h))
        h = self.norm3(_linear(self.fc3, h, dtype), f32)
        return F.relu(x + self._drop(h, generator, record))


class BlockSequence(nn.Module):
    """``block0``, ``block1``, ... over one neighbour table of ``k``."""

    def __init__(self, depth: int, channels: int, groups: int, k: int,
                 rates: Sequence[float], qkv_bias: bool = True,
                 device=None):
        super().__init__()
        self.k = k
        for i in range(depth):
            setattr(self, f"block{i}", Block(channels, groups, rates[i],
                                             qkv_bias, device=device))
        self.depth = depth

    def forward(self, x, level: _Level, dtype, generator=None, record=None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, level, self.k, dtype,
                                           generator, record)
        return x


def grid_clusters(pos: torch.Tensor, sample: torch.Tensor,
                  counts: Sequence[int], grid: float):
    """The grid pooling's clusters of a level: each sample's points by the
    cells ``floor((p - lo) / grid)`` of ``grid`` from the sample's minimum
    corner ``lo``, clusters ordered by (sample, z, y, x) as Pointcept's
    ``torch.unique`` over ``voxel_grid`` orders them.  Returns ``(order
    (rows by cluster), ptr int32 [S + 1], cluster int64 [n] (each row's),
    the next level's counts per sample (host), offsets (int32 [B + 1]),
    sample ids and mean positions)``.  One synchronisation: the per-sample
    cluster counts (with the largest cell index, which must fit its
    bits)."""
    n = pos.shape[0]
    nb = len(counts)
    s64 = sample.to(torch.int64)
    lo = torch.full((nb, 3), float("inf"), device=pos.device).scatter_reduce(
        0, s64[:, None].expand(-1, 3), pos, "amin")
    edge = torch.full((), grid, dtype=torch.float32, device=pos.device)
    cell = torch.floor((pos - lo[s64]) / edge).to(torch.int64)
    key = ((s64 << (3 * _AXIS_BITS)) | (cell[:, 2] << (2 * _AXIS_BITS))
           | (cell[:, 1] << _AXIS_BITS) | cell[:, 0])
    skey, order = torch.sort(key)
    head = torch.ones(n, dtype=torch.bool, device=pos.device)
    head[1:] = skey[1:] != skey[:-1]
    sid = torch.cumsum(head, 0) - 1
    per_sample = torch.zeros(nb, dtype=torch.int64, device=pos.device)
    per_sample.index_add_(0, skey >> (3 * _AXIS_BITS), head.to(torch.int64))
    top = cell.max().reshape(1) if n else per_sample.new_zeros(1)
    read = torch.cat([per_sample, top]).tolist()
    next_counts, top = read[:nb], read[nb]
    if top >= 1 << _AXIS_BITS:
        raise ValueError(f"a sample spans more than {1 << _AXIS_BITS} cells "
                         f"of {grid}")
    s = int(sum(next_counts))
    ptr = torch.full((s + 1,), n, dtype=torch.int64, device=pos.device)
    ptr.scatter_reduce_(0, sid, torch.arange(n, device=pos.device), "amin")
    cluster = torch.empty(n, dtype=torch.int64, device=pos.device)
    cluster[order] = sid
    size = (ptr[1:] - ptr[:-1]).to(torch.float64)
    mean = torch.zeros((s, 3), dtype=torch.float64, device=pos.device)
    mean.index_add_(0, cluster, pos.to(torch.float64))
    mean = (mean / size[:, None]).to(torch.float32)
    next_sample = (skey[ptr[:-1]] >> (3 * _AXIS_BITS)).to(torch.int32)
    offsets = torch.cat([per_sample.new_zeros(1),
                         torch.cumsum(per_sample, 0)]).to(torch.int32)
    return (order, ptr.to(torch.int32), cluster, next_counts, offsets,
            next_sample, mean)


class GridPool(nn.Module):
    """Linear (no bias), BN, ReLU, then the clusters' maxima."""

    def __init__(self, in_channels: int, out_channels: int, grid: float,
                 device=None):
        super().__init__()
        self.grid = grid
        self.fc = nn.Linear(in_channels, out_channels, bias=False,
                            device=device)
        self.norm = PointBatchNorm(out_channels, device=device)

    def forward(self, x, level: _Level, k_max: int, dtype, record=None):
        """``(pooled features, the next level, each row's cluster)``."""
        y = F.relu(self.norm(_linear(self.fc, x, dtype), torch.float32))
        with torch.no_grad():
            order, ptr, cluster, counts, offsets, sample, pos = \
                grid_clusters(level.pos, level.sample, level.counts,
                              self.grid)
        if record is not None:
            record.append(("level", level.lvl + 1, list(counts)))
        y = seg.segment_csr(y[order], ptr, None, "max")
        nxt = _Level(level.lvl + 1, pos, counts, offsets, sample, k_max,
                     record)
        return y, nxt, cluster


class UnpoolWithSkip(nn.Module):
    """``ReLU(BN(Linear(x)))[cluster] + ReLU(BN(Linear(skip)))``."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, device=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels, device=device)
        self.norm = PointBatchNorm(out_channels, device=device)
        self.proj_skip = nn.Linear(skip_channels, out_channels,
                                   device=device)
        self.norm_skip = PointBatchNorm(out_channels, device=device)

    def forward(self, x, skip, cluster, dtype):
        f32 = torch.float32
        up = F.relu(self.norm(_linear(self.proj, x, dtype), f32))
        s = F.relu(self.norm_skip(_linear(self.proj_skip, skip, dtype), f32))
        return s + up.index_select(0, cluster)


class GVAPatchEmbed(nn.Module):
    """``ReLU(BN(Linear(x)))`` (no bias), then a block sequence."""

    def __init__(self, cfg: PTv2Config, in_channels: int, device=None):
        super().__init__()
        c = cfg.patch_embed_channels
        self.proj = nn.Linear(in_channels, c, bias=False, device=device)
        self.norm = PointBatchNorm(c, device=device)
        self.blocks = BlockSequence(
            cfg.patch_embed_depth, c, cfg.patch_embed_groups,
            cfg.patch_embed_neighbours, [0.0] * cfg.patch_embed_depth,
            cfg.qkv_bias, device=device)

    def forward(self, feats, level, dtype, generator=None, record=None):
        x = F.relu(self.norm(_linear(self.proj, feats, dtype),
                             torch.float32))
        return self.blocks(x, level, dtype, generator, record)


class _Head(nn.Module):
    def __init__(self, channels: int, num_classes: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels, device=device)
        self.norm = PointBatchNorm(channels, device=device)
        self.fc2 = nn.Linear(channels, num_classes, device=device)

    def forward(self, x):
        return self.fc2(F.relu(self.norm(self.fc1(x))))


class _Stage(nn.Module):
    """A stage: its pooling (``down``) or unpooling (``up``), then its block
    sequence (``blocks``)."""


class PointTransformerV2Seg(nn.Module):
    """PTv2 + head; ``forward(batch, generator=None)`` returns ``{"logits"}``
    over the level-0 rows of a ``"ptv2"`` batch (zero on its padding
    rows)."""

    def __init__(self, cfg: PTv2Config, in_channels: int, num_classes: int,
                 device="cuda", seed: Optional[int] = 0,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.record: Optional[list] = None
        enc_dp, dec_dp = drop_path_rates(cfg)
        ec = [cfg.patch_embed_channels] + list(cfg.enc_channels)
        dc = list(cfg.dec_channels) + [ec[-1]]
        self.stem = GVAPatchEmbed(cfg, in_channels, device=device)
        self.enc = nn.Module()
        self.dec = nn.Module()
        for s, depth in enumerate(cfg.enc_depths):
            stage = _Stage()
            stage.down = GridPool(ec[s], ec[s + 1], cfg.grid_sizes[s],
                                  device=device)
            stage.blocks = BlockSequence(depth, ec[s + 1], cfg.enc_groups[s],
                                         cfg.enc_neighbours[s], enc_dp[s],
                                         cfg.qkv_bias, device=device)
            setattr(self.enc, f"enc{s}", stage)
        for s, depth in enumerate(cfg.dec_depths):
            stage = _Stage()
            stage.up = UnpoolWithSkip(dc[s + 1], ec[s], dc[s], device=device)
            stage.blocks = BlockSequence(depth, dc[s], cfg.dec_groups[s],
                                         cfg.dec_neighbours[s], dec_dp[s],
                                         cfg.qkv_bias, device=device)
            setattr(self.dec, f"dec{s}", stage)
        self.head = _Head(dc[0], num_classes, device=device)
        for name, m in self.named_modules():
            if isinstance(m, Block):
                m.name = name
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def _neighbours(self, level: int) -> List[int]:
        """The table widths that the stages at ``level`` take."""
        cfg = self.cfg
        ks = [cfg.patch_embed_neighbours] if level == 0 else \
            [cfg.enc_neighbours[level - 1]]
        if level < len(cfg.dec_depths):
            ks.append(cfg.dec_neighbours[level])
        return ks

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        graph = batch["graph"]
        dtype = self.compute_dtype
        record = self.record
        counts = [int(c) for c in graph["counts"][0]]
        n0 = sum(counts)
        cap = batch["feats"].shape[0]
        pos = batch["pos"][:n0].to(torch.float32)
        level = _Level(0, pos, counts, graph["offset"],
                       graph["levels"][0]["batch_idx"][:n0],
                       max(self._neighbours(0)), record)
        x = self.stem(batch["feats"][:n0], level, dtype, generator, record)
        skips = []
        for s in range(len(self.cfg.enc_depths)):
            stage = getattr(self.enc, f"enc{s}")
            with trace.span("ptv2.pool", device=x):
                y, nxt, cluster = stage.down(
                    x, level, max(self._neighbours(s + 1)), dtype, record)
            skips.append((x, level, cluster))
            x, level = stage.blocks(y, nxt, dtype, generator, record), nxt
        for s in reversed(range(len(self.cfg.dec_depths))):
            stage = getattr(self.dec, f"dec{s}")
            skip, level, cluster = skips[s]
            with trace.span("ptv2.unpool", device=x):
                x = stage.up(x, skip, cluster, dtype)
            x = stage.blocks(x, level, dtype, generator, record)
        logits = self.head(x)
        if cap > n0:
            logits = torch.cat([logits, logits.new_zeros(
                cap - n0, logits.shape[1])])
        return {"logits": logits}
