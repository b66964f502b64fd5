"""Point Transformer V3 (PTv3-m1 base) for semantic segmentation.

The model of Wu et al., "Point Transformer V3: Simpler, Faster, Stronger"
(CVPR 2024, arXiv:2312.10035), as Pointcept's
``point_transformer_v3m1_base.py`` builds it, over the batches of the
``"ptv3"`` collate route (:func:`..ops.sparse_graph.build_ptv3_graph`):

* embedding (``stem``): submanifold conv ``k = 5`` without bias, BatchNorm
  (eps 1e-3, momentum 0.01), GELU;
* blocks (pre-norm): ``x += LN(Linear(SubMConv_k3(x) + b))`` (the xCPE,
  its kernel map shared by every block of the level), ``x +=
  DropPath(Attn(LN(x)))``, ``x += DropPath(Linear(GELU(Linear(LN(x),
  4C)), C))``;
* attention: ``Linear(C, 3C)``, gathered in the order ``i % 4`` of the
  block's index ``i`` in its stage, cut into patches
  (:func:`..ops.serialize.patch_indices`), softmax attention per patch and
  head (head size ``C / heads``, scale its inverse square root) through
  ``scaled_dot_product_attention``, each point's own slot taken back, then
  ``Linear(C, C)``;
* serialized pooling (stride 2): ``Linear`` then the maximum over each
  parent cell's points (``ops.segment.segment_csr``), BatchNorm, GELU; the
  coarse codes are the fine ones ``>> 3``, the orders re-drawn;
* serialized unpooling: ``GELU(BN(Linear(skip))) + GELU(BN(Linear(x)))
  [parent]``;
* head ``Linear(dec_channels[0], classes)``.

DropPath draws a keep mask per point (the source applies timm's DropPath
to the ``[N, C]`` features), rates ``linspace(0, drop_path)`` over the
encoder's blocks and over the decoder's, reversed within each decoder
stage.  The four orders are permuted by one draw at level 0 and one at each
pooling.  Both draw from the step's generator; with none (eval) nothing is
dropped and the orders keep their stated sequence.

Precision: ``compute_dtype`` (bfloat16 on the card) rounds the operands of
the linear layers of the blocks, pooling and unpooling and of the
attention, whose outputs come out in it too, and of the sparse
convolutions (float32 accumulation and output there); the residual stream,
norms, pooling maximum, head, loss and parameters stay float32.
Pointcept trains under float16 autocast.

Traced (``utils/trace.py``), device spans ``ptv3.serialize`` (level 0 and
each pooling), ``ptv3.cpe``, ``ptv3.attention`` (qkv, gather, pad, the
attention, unpad, projection), ``ptv3.attention.core`` (the attention call
alone), ``ptv3.mlp``, ``ptv3.pool`` and ``ptv3.unpool``; counters
``ptv3.tokens`` and ``ptv3.pad_tokens``: the real points and the padding
copies through each attention.

``record``: a list that, while set, receives each forward's random draws
(``("perm", level, [4 ints])`` and ``("keep", block name, sublayer, bool
mask over the level's rows)``, on the host), for a reference to replay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops import segment as seg
from ..ops import serialize as ser
from ..ops.sparse_conv import sparse_conv_submanifold
from ..utils import trace
from .norm import MaskedBatchNorm
from .sparse_blocks import SparseConv

__all__ = ["PTv3Config", "PTV3_PRESETS", "PTv3Embedding",
           "SerializedAttention", "PTv3Block", "SerializedPooling",
           "SerializedUnpooling", "PointTransformerV3Seg", "drop_path_rates"]


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    """The widths of a PTv3 (Pointcept's ``PT-v3m1`` arguments); every
    pooling has stride 2, the pyramid the collate builds."""

    orders: Tuple[str, ...] = ser.ORDERS
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024, 1024)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_num_head: Tuple[int, ...] = (4, 4, 8, 16)
    dec_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path: float = 0.3
    stem_kernel: int = 5


PTV3_PRESETS = {
    # the published base model (46.2M parameters in the paper)
    "PTv3-m1-base": PTv3Config(),
    # a narrow two-level net for CPU smokes and tests
    "PTv3Test": PTv3Config(enc_depths=(1, 2), enc_channels=(16, 32),
                           enc_num_head=(2, 2), enc_patch_size=(8, 8),
                           dec_depths=(1,), dec_channels=(16,),
                           dec_num_head=(2,), dec_patch_size=(8,)),
}


def _sdpa_backend(x: torch.Tensor) -> SDPBackend:
    """The attention's one backend: FlashAttention-2 on the card (cuDNN's,
    PyTorch's pick there, builds a plan for every new patch length), alone,
    so that a call it cannot take raises; the math one on the CPU."""
    return SDPBackend.FLASH_ATTENTION if x.is_cuda else SDPBackend.MATH


def drop_path_rates(cfg: PTv3Config):
    """``(encoder rates per stage, decoder rates per stage)``."""
    def split(depths, rates):
        out, at = [], 0
        for d in depths:
            out.append(rates[at:at + d])
            at += d
        return out

    enc = torch.linspace(0, cfg.drop_path, sum(cfg.enc_depths)).tolist()
    dec = torch.linspace(0, cfg.drop_path, sum(cfg.dec_depths)).tolist()
    return (split(cfg.enc_depths, enc),
            [list(reversed(r)) for r in split(cfg.dec_depths, dec)])


def _linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``mod(x)`` with operands rounded to ``dtype``, out in ``dtype``."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), b)


def _keep_mask(rows: int, p: float, generator, device):
    """A DropPath keep mask over ``rows`` points (host draw, then moved),
    or None when nothing is dropped."""
    if p <= 0.0 or generator is None:
        return None, None
    keep = torch.rand(rows, generator=generator,
                      device=generator.device) >= p
    return keep, keep.to(device)


class _Level:
    """One level's serialization and patches in a forward."""

    def __init__(self, graph: Dict, lvl: int, code: torch.Tensor,
                 rows: List[str], depth: int, patch_sizes: Sequence[int]):
        info = graph["levels"][lvl]
        self.lvl = lvl
        self.nbr = info["sub_nbr"]
        self.counts = graph["counts"][lvl]
        self.n = int(sum(self.counts))
        self.cap = int(info["valid"].shape[0])
        self.code, self.rows, self.depth = code, rows, depth
        self.order = torch.argsort(code, dim=1)
        self.inverse = ser.inverse_of(self.order)
        self.patches = {}
        for k in sorted(set(patch_sizes)):
            pad, unpad, total = ser.patch_indices(self.counts, k,
                                                  code.device)
            self.patches[k] = (pad, unpad, total,
                               ser.patch_runs(self.counts, k))


class PTv3Embedding(nn.Module):
    """Submanifold conv (no bias) -> BatchNorm -> GELU."""

    def __init__(self, in_channels: int, channels: int, kernel: int,
                 device=None):
        super().__init__()
        self.conv = SparseConv(kernel ** 3, in_channels, channels,
                               submanifold=True, device=device)
        self.norm = MaskedBatchNorm(channels, momentum=0.99, epsilon=1e-3,
                                    device=device)

    def forward(self, feats, nbr, valid, dtype):
        x = sparse_conv_submanifold(feats, self.conv.weight, nbr, dtype)
        return F.gelu(self.norm(x, valid))


class _CPE(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = SparseConv(27, channels, channels, submanifold=True,
                               device=device)
        self.conv_bias = nn.Parameter(torch.zeros(channels, device=device))
        self.linear = nn.Linear(channels, channels, device=device)
        self.norm = nn.LayerNorm(channels, device=device)

    def forward(self, x, nbr, dtype):
        y = sparse_conv_submanifold(x, self.conv.weight, nbr, dtype) \
            + self.conv_bias
        return self.norm(_linear(self.linear, y, dtype).float())


class SerializedAttention(nn.Module):
    """Patch attention along one serialization order."""

    def __init__(self, channels: int, heads: int, patch: int,
                 order_index: int, qkv_bias: bool = True, device=None):
        super().__init__()
        self.heads, self.patch, self.order_index = heads, patch, order_index
        self.qkv = nn.Linear(channels, 3 * channels, bias=qkv_bias,
                             device=device)
        self.proj = nn.Linear(channels, channels, device=device)

    def forward(self, x: torch.Tensor, level: _Level, dtype) -> torch.Tensor:
        c = x.shape[1]
        h, d = self.heads, c // self.heads
        pad, unpad, total, runs = level.patches[self.patch]
        order = level.order[self.order_index]
        trace.count("ptv3.tokens", level.n)
        trace.count("ptv3.pad_tokens", total - level.n)
        qkv = _linear(self.qkv, x, dtype)[order[pad]].view(total, 3, h, d)
        outs = []
        for start, n, length in runs:
            blk = qkv[start:start + n * length].view(n, length, 3, h, d)
            q, k, v = blk.permute(2, 0, 3, 1, 4).unbind(0)
            with trace.span("ptv3.attention.core", device=x), \
                    sdpa_kernel(_sdpa_backend(q)):
                o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            outs.append(o.transpose(1, 2).reshape(n * length, c))
        feat = outs[0] if len(outs) == 1 else torch.cat(outs)
        feat = feat[unpad[level.inverse[self.order_index, :level.n]]]
        if level.cap > level.n:
            feat = torch.cat([feat, feat.new_zeros(level.cap - level.n, c)])
        return _linear(self.proj, feat, dtype).float()


class _MLP(nn.Module):
    def __init__(self, channels: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden, device=device)
        self.fc2 = nn.Linear(hidden, channels, device=device)

    def forward(self, x, dtype):
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype)),
                       dtype).float()


class PTv3Block(nn.Module):
    """xCPE, then pre-norm attention and MLP, each with DropPath."""

    def __init__(self, channels: int, heads: int, patch: int,
                 order_index: int, drop_path: float, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, device=None):
        super().__init__()
        self.drop_path = drop_path
        self.cpe = _CPE(channels, device=device)
        self.norm1 = nn.LayerNorm(channels, device=device)
        self.attn = SerializedAttention(channels, heads, patch, order_index,
                                        qkv_bias, device=device)
        self.norm2 = nn.LayerNorm(channels, device=device)
        self.mlp = _MLP(channels, int(channels * mlp_ratio), device=device)
        self.name = ""

    def _drop(self, y, level, which, generator, record):
        host, keep = _keep_mask(level.cap, self.drop_path, generator,
                                y.device)
        if keep is None:
            return y
        if record is not None:
            record.append(("keep", self.name, which, host))
        return torch.where(keep[:, None], y / (1.0 - self.drop_path), 0.0)

    def forward(self, x, level: _Level, dtype, generator=None, record=None):
        with trace.span("ptv3.cpe", device=x):
            x = x + self.cpe(x, level.nbr, dtype)
        with trace.span("ptv3.attention", device=x):
            y = self.attn(self.norm1(x), level, dtype)
        x = x + self._drop(y, level, "attn", generator, record)
        with trace.span("ptv3.mlp", device=x):
            y = self.mlp(self.norm2(x), dtype)
        return x + self._drop(y, level, "mlp", generator, record)


class SerializedPooling(nn.Module):
    """Stride-2 pooling over the parent cells: Linear, maximum, BN, GELU."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels, device=device)
        self.norm = MaskedBatchNorm(out_channels, momentum=0.99,
                                    epsilon=1e-3, device=device)

    def forward(self, x, info: Dict, valid_next, dtype):
        cap_next = valid_next.shape[0]
        y = _linear(self.proj, x, dtype).float()[info["pool_perm"]]
        y = seg.segment_csr(y, info["pool_ptr"], None, "max")[:cap_next]
        return F.gelu(self.norm(y, valid_next))


class SerializedUnpooling(nn.Module):
    """Back to the finer level: the skip's projection plus the coarse
    features' projection taken at each point's parent cell."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, device=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels, device=device)
        self.norm = MaskedBatchNorm(out_channels, momentum=0.99,
                                    epsilon=1e-3, device=device)
        self.proj_skip = nn.Linear(skip_channels, out_channels,
                                   device=device)
        self.norm_skip = MaskedBatchNorm(out_channels, momentum=0.99,
                                         epsilon=1e-3, device=device)

    def forward(self, x, skip, parent, valid, valid_skip, dtype):
        up = F.gelu(self.norm(_linear(self.proj, x, dtype).float(), valid))
        s = F.gelu(self.norm_skip(_linear(self.proj_skip, skip, dtype)
                                  .float(), valid_skip))
        return s + up[parent]


class _Stage(nn.Module):
    """A stage: its pooling (``down``) or unpooling (``up``), then
    ``block0``, ``block1``, ..."""


class PointTransformerV3Seg(nn.Module):
    """PTv3 + linear head; ``forward(batch, generator=None)`` returns
    ``{"logits"}`` over the level-0 rows of a ``"ptv3"`` batch."""

    def __init__(self, cfg: PTv3Config, in_channels: int, num_classes: int,
                 device="cuda", seed: Optional[int] = 0,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.record: Optional[list] = None
        ec, dc = cfg.enc_channels, cfg.dec_channels
        enc_dp, dec_dp = drop_path_rates(cfg)
        self.stem = PTv3Embedding(in_channels, ec[0], cfg.stem_kernel,
                                  device=device)
        self.enc = nn.Module()
        for s, depth in enumerate(cfg.enc_depths):
            stage = _Stage()
            if s > 0:
                stage.down = SerializedPooling(ec[s - 1], ec[s],
                                               device=device)
            for i in range(depth):
                setattr(stage, f"block{i}", PTv3Block(
                    ec[s], cfg.enc_num_head[s], cfg.enc_patch_size[s],
                    i % len(cfg.orders), enc_dp[s][i], cfg.mlp_ratio,
                    cfg.qkv_bias, device=device))
            setattr(self.enc, f"enc{s}", stage)
        widths = list(dc) + [ec[-1]]
        self.dec = nn.Module()
        for s in reversed(range(len(cfg.dec_depths))):
            stage = _Stage()
            stage.up = SerializedUnpooling(widths[s + 1], ec[s], dc[s],
                                           device=device)
            for i in range(cfg.dec_depths[s]):
                setattr(stage, f"block{i}", PTv3Block(
                    dc[s], cfg.dec_num_head[s], cfg.dec_patch_size[s],
                    i % len(cfg.orders), dec_dp[s][i], cfg.mlp_ratio,
                    cfg.qkv_bias, device=device))
            setattr(self.dec, f"dec{s}", stage)
        self.head = nn.Linear(dc[0], num_classes, device=device)
        for name, m in self.named_modules():
            if isinstance(m, PTv3Block):
                m.name = name
        if seed is not None:
            from ..models.segmentation import init_parameters

            init_parameters(self, torch.Generator().manual_seed(seed))

    def _patch_sizes(self, lvl: int):
        cfg = self.cfg
        sizes = [cfg.enc_patch_size[lvl]]
        if lvl < len(cfg.dec_depths):
            sizes.append(cfg.dec_patch_size[lvl])
        return sizes

    def _shuffle(self, rows, lvl, generator):
        if generator is None:
            return list(rows)
        perm = torch.randperm(len(rows), generator=generator,
                              device=generator.device).tolist()
        if self.record is not None:
            self.record.append(("perm", lvl, perm))
        return [rows[i] for i in perm]

    def _level0(self, graph, generator) -> _Level:
        info = graph["levels"][0]
        depth = int(graph["depth"])
        with trace.span("ptv3.serialize", device=graph["grid"]):
            rows = self._shuffle(self.cfg.orders, 0, generator)
            code = torch.stack([ser.encode(graph["grid"], info["batch_idx"],
                                           depth, o) for o in rows])
            return _Level(graph, 0, code, rows, depth, self._patch_sizes(0))

    def _next_level(self, graph, level: _Level, generator) -> _Level:
        lvl = level.lvl + 1
        info = graph["levels"][lvl]
        nb = len(graph["counts"][0])
        with trace.span("ptv3.serialize", device=level.code):
            head = graph["levels"][level.lvl]["pool_head"]
            pad_code = nb << (3 * (level.depth - 1))
            code = torch.where(info["valid"], level.code[:, head] >> 3,
                               pad_code)
            perm_rows = self._shuffle(range(len(level.rows)), lvl, generator)
            code = code[perm_rows]
            rows = [level.rows[i] for i in perm_rows]
            return _Level(graph, lvl, code, rows, level.depth - 1,
                          self._patch_sizes(lvl))

    def _blocks(self, stage, x, level, generator):
        dtype = self.compute_dtype
        i = 0
        while hasattr(stage, f"block{i}"):
            x = getattr(stage, f"block{i}")(x, level, dtype, generator,
                                            self.record)
            i += 1
        return x

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        graph = batch["graph"]
        dtype = self.compute_dtype
        levels = [self._level0(graph, generator)]
        x = self.stem(batch["feats"], graph["conv0_nbr"],
                      graph["levels"][0]["valid"], dtype)
        skips = []
        for s in range(len(self.cfg.enc_depths)):
            stage = getattr(self.enc, f"enc{s}")
            if s > 0:
                skips.append(x)
                info = graph["levels"][s - 1]
                with trace.span("ptv3.pool", device=x):
                    x = stage.down(x, info, graph["levels"][s]["valid"],
                                   dtype)
                levels.append(self._next_level(graph, levels[-1], generator))
            x = self._blocks(stage, x, levels[s], generator)
        for s in reversed(range(len(self.cfg.dec_depths))):
            stage = getattr(self.dec, f"dec{s}")
            info = graph["levels"][s]
            with trace.span("ptv3.unpool", device=x):
                x = stage.up(x, skips[s], info["parent"],
                             graph["levels"][s + 1]["valid"], info["valid"],
                             dtype)
            x = self._blocks(stage, x, levels[s], generator)
        return {"logits": self.head(x)}
