"""The Res16UNet sparse-voxel UNet stages — the paper's 3D backbone.

The port of ``deepviewagg_tpu/nn/res16unet.py`` (``RES16_PRESETS``,
``Stem``, ``DownStage``, ``UpStage``, ``Res16UNet``; the reference's
modules/MinkowskiEngine/res16unet.py): a stem conv, stride-2 encoder stages
of residual blocks and transpose-conv decoder stages with skip
concatenation.  All spatial indexing comes precomputed in the batch's
``graph`` dict (one entry per resolution level, built by
:func:`deepviewagg_tpu_torch.ops.sparse_graph.graph_to_device`).
"""

from __future__ import annotations

import torch
from torch import nn

from .sparse_blocks import (BottleneckBlock, ResBlock, SEBottleneckBlock,
                            SEResBlock, SparseConvNormRelu)

__all__ = ["Stem", "DownStage", "UpStage", "Res16UNet", "RES16_PRESETS"]

# (layers, planes, block) per named variant — the JAX package's table
# (modules/MinkowskiEngine/res16unet.py:246-588 and the DeepViewAgg compact
# configs' channel plans); 50/101 take the bottleneck block, the SE family
# the squeeze-excitation blocks
_BASE = (32, 64, 128, 256, 256, 256, 256, 256)
RES16_PRESETS = {
    "Res16UNet14": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96), "basic"),
    "Res16UNet18": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96), "basic"),
    "Res16UNet34": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96), "basic"),
    "Res16UNet14Full": ((1, 1, 1, 1, 1, 1, 1, 1), _BASE, "basic"),
    "Res16UNet18Full": ((2, 2, 2, 2, 2, 2, 2, 2), _BASE, "basic"),
    "Res16UNet34Full": ((2, 3, 4, 6, 2, 2, 2, 2), _BASE, "basic"),
    "Res16UNet50": ((2, 3, 4, 6, 2, 2, 2, 2), _BASE, "bottleneck"),
    "Res16UNet101": ((2, 3, 4, 23, 2, 2, 2, 2), _BASE, "bottleneck"),
    "Res16UNet14A": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96), "basic"),
    "Res16UNet14A2": ((1, 1, 1, 1, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96), "basic"),
    "Res16UNet14B": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 128, 128), "basic"),
    "Res16UNet14B2": ((1, 1, 1, 1, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128), "basic"),
    "Res16UNet14B3": ((2, 2, 2, 2, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 128, 128), "basic"),
    "Res16UNet14C": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 192, 192, 128, 128), "basic"),
    "Res16UNet14D": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 384, 384, 384, 384), "basic"),
    "Res16UNet18A": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96), "basic"),
    "Res16UNet18B": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128), "basic"),
    "Res16UNet18D": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384), "basic"),
    "Res16UNet32B": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 64, 64, 64), "basic"),
    "Res16UNet34A": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64), "basic"),
    "Res16UNet34B": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32), "basic"),
    "Res16UNet34C": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96), "basic"),
    "SERes16UNet34": ((2, 3, 4, 6, 2, 2, 2, 2), _BASE, "se_basic"),
    "SERes16UNet50": ((2, 3, 4, 6, 2, 2, 2, 2), _BASE, "se_bottleneck"),
    # tiny config for CPU tests / smoke runs (not a reference preset)
    "Res16UNetTest": ((1, 1, 1, 1, 1, 1, 1, 1), (8, 8, 16, 16, 16, 8, 8, 8), "basic"),
}

_SUB_K = 27    # 3x3x3 submanifold kernel
_DOWN_K = 8    # 2x2x2 stride-2 kernel


_BLOCKS = {"basic": ResBlock, "bottleneck": BottleneckBlock,
           "se_basic": SEResBlock, "se_bottleneck": SEBottleneckBlock}


def _add_blocks(stage: nn.Module, block: str, in_channels: int,
                out_channels: int, num_blocks: int, device) -> None:
    """``num_blocks`` blocks of kind ``block`` under the flax auto-names
    (``ResBlock_<i>``, ``BottleneckBlock_<i>``, ``SEResBlock_<i>`` ...)."""
    cls = _BLOCKS[block]
    stage.blocks = []
    for i in range(num_blocks):
        name = f"{cls.__name__}_{i}"
        setattr(stage, name, cls(in_channels if i == 0 else out_channels,
                                 out_channels, device=device))
        stage.blocks.append(name)


def _run_blocks(stage: nn.Module, x, level):
    for name in stage.blocks:
        x = getattr(stage, name)(x, level["sub_nbr"], level["valid"],
                                 level.get("batch_idx"))
    return x


class Stem(nn.Module):
    """Initial submanifold conv over the collate-time ``conv0_nbr`` table."""

    def __init__(self, in_channels: int, out_channels: int = 32,
                 kernel_size: int = 3, device=None):
        super().__init__()
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            kernel_size ** 3, in_channels, out_channels, submanifold=True,
            device=device)

    def forward(self, feats, graph):
        return self.SparseConvNormRelu_0(
            feats, graph["conv0_nbr"], graph["levels"][0]["valid"])


class DownStage(nn.Module):
    """Stride-2 conv into the next level + N residual blocks there."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int,
                 block: str = "basic", device=None):
        super().__init__()
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            _DOWN_K, in_channels, in_channels, device=device)
        _add_blocks(self, block, in_channels, out_channels, num_blocks, device)

    def forward(self, feats, graph, level_in: int):
        src = graph["levels"][level_in]
        dst = graph["levels"][level_in + 1]
        # the precomputed transpose map gives the gather-only backward
        x = self.SparseConvNormRelu_0(feats, src["down_nbr"], dst["valid"],
                                      nbr_t=src["up_nbr"])
        return _run_blocks(self, x, dst)


class UpStage(nn.Module):
    """Transpose stride-2 conv back up + skip concat + N residual blocks."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 num_blocks: int, block: str = "basic", device=None):
        super().__init__()
        self.SparseConvNormRelu_0 = SparseConvNormRelu(
            _DOWN_K, in_channels, out_channels, device=device)
        _add_blocks(self, block, out_channels + skip_channels, out_channels,
                    num_blocks, device)

    def forward(self, feats, skip, graph, level_out: int):
        dst = graph["levels"][level_out]
        # the transpose of the up map is the down map
        x = self.SparseConvNormRelu_0(feats, dst["up_nbr"], dst["valid"],
                                      nbr_t=dst["down_nbr"])
        x = torch.cat([x, skip], dim=-1)
        return _run_blocks(self, x, dst)


class Res16UNet(nn.Module):
    """The whole encoder / decoder (flax ``Res16UNet``, sub-modules under its
    auto-names ``Stem_0``, ``DownStage_<i>``, ``UpStage_<j>``): per-voxel
    features at level 0, ``planes[-1]`` channels."""

    def __init__(self, in_channels: int, layers, planes, block: str = "basic",
                 init_dim: int = 32, stem_kernel: int = 3, device=None):
        super().__init__()
        self.n_down = n_down = len(layers) // 2
        self.Stem_0 = Stem(in_channels, init_dim, stem_kernel, device=device)
        c, skip_c = init_dim, [init_dim]
        for i in range(n_down):
            setattr(self, f"DownStage_{i}", DownStage(
                c, planes[i], layers[i], block, device=device))
            c = planes[i]
            if i < n_down - 1:
                skip_c.append(c)
        for j in range(n_down):
            setattr(self, f"UpStage_{j}", UpStage(
                c, skip_c[n_down - 1 - j], planes[n_down + j],
                layers[n_down + j], block, device=device))
            c = planes[n_down + j]
        self.out_channels = c

    def forward(self, feats, graph):
        x = self.Stem_0(feats, graph)
        skips = [x]
        for i in range(self.n_down):
            x = getattr(self, f"DownStage_{i}")(x, graph, i)
            if i < self.n_down - 1:
                skips.append(x)
        for j in range(self.n_down):
            lvl_out = self.n_down - 1 - j
            x = getattr(self, f"UpStage_{j}")(x, skips[lvl_out], graph,
                                               lvl_out)
        return x
