"""The reference's scratch 2D stack: WS convs, ResBlocks, ResNet down/up
stages and the compact-format UNet tower of the published No3D /
from-scratch configs (conf/models/segmentation/multimodal/no3d.yaml).

The port of ``deepviewagg_tpu/modules/scratch2d.py``.  Unlike the towers of
:mod:`image_encoders`, these modules pin the reference's own scratch
formulas (modalities/image.py):

  * ``standardize_weights`` (image.py:39-50): per-out-channel mean over
    (in, kh, kw), UNBIASED std, ``w / ((std + 1e-5) * sqrt(cin))``;
  * ``ReLUWS`` (image.py:110-125): ``relu(x) * sqrt(2 / (1 - 1/pi))``;
  * reflect padding on every 3x3 conv, zeros for the transposed convs;
  * GroupNorm with ``groups = max(c // 16, 1)`` and eps 1e-5;
  * the ResBlock's activation BEFORE the residual add, a plain (non-WS)
    1x1 conv + norm shortcut;
  * ``ResNetDown``'s width rule ``nc_stride_out = nc_in if stride > 1 and
    N > 0 else nc_out`` and ``ResNetUp``'s conv_in -> concat-skip -> blocks
    order.

Channels-first tensors (the towers run inside :func:`image_encoders.
run_tower`); the convolutions run in the activations' dtype.  Parameters
carry the flax names (``down<i>/conv_in``, ``block<j>/conv1``, ``last/conv``
...).  A conv's ``weight`` is the torch layout of the flax kernel: OIHW for
:class:`WSConv2d`, ``[in, out, kh, kw]`` for :class:`WSConvTranspose2d`,
unflipped (``conv_transpose2d`` is the transposed convolution itself; the
JAX module flips the kernel to run it as a dilated-input convolution).
Only group-norm towers are ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .image_encoders import ChannelDropout

__all__ = ["WSConv2d", "WSConvTranspose2d", "relu_ws", "RefResBlock",
           "ResNetDown2D", "ResNetUp2D", "UnaryConv2D", "UNetWS",
           "unetws_from_cfg", "tower_cfg_out_channels"]

# ReLUWS gain (image.py:119): keeps activation variance ~1 under WS convs
_RELU_WS_SCALE = math.sqrt(2.0 / (1.0 - 1.0 / math.pi))


def relu_ws(x, ws: bool):
    y = F.relu(x)
    return y * _RELU_WS_SCALE if ws else y


def _standardize(w, fan_in: int, dims: Tuple[int, ...]):
    """The reference's ``standardize_weights``: zero-mean, unbiased-std
    normalized over ``dims``, scaled by ``1 / sqrt(fan_in)``."""
    n = math.prod(w.shape[d] for d in dims)
    centered = w - w.mean(dim=dims, keepdim=True)
    var = (centered * centered).sum(dim=dims, keepdim=True) / (n - 1)
    return centered / ((torch.sqrt(var) + 1e-5) * math.sqrt(fan_in))


class WSConv2d(nn.Module):
    """``Conv2dWS`` (image.py:53-73): weight standardization per out channel
    (``fan_in = cin``) and reflect or zero padding; ``standardize=False`` is
    the plain ``nn.Conv2d``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 0,
                 pad_mode: str = "reflect", standardize: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.strides, self.padding = strides, padding
        self.pad_mode = "reflect" if pad_mode == "reflect" else "constant"
        self.standardize = standardize
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        w = self.weight
        if self.standardize:
            w = _standardize(w, w.shape[1], (1, 2, 3))
        p = self.padding
        if p > 0:
            x = F.pad(x, (p, p, p, p), mode=self.pad_mode)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w.to(x.dtype), b, stride=self.strides)


class WSConvTranspose2d(nn.Module):
    """``ConvTranspose2dWS`` (image.py:76-107): the torch transposed conv
    with standardization per INPUT channel and ``fan_in = out_channels``
    (torch's weight layout is ``[in, out, kh, kw]``; ``standardize_weights``
    normalizes over dim 0's slices and scales by sqrt(shape[1]))."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 2,
                 strides: int = 2, padding: int = 0, standardize: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.strides, self.padding = strides, padding
        self.standardize = standardize
        self.weight = nn.Parameter(torch.empty(
            in_channels, features, kernel_size, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        w = self.weight
        if self.standardize:
            w = _standardize(w, w.shape[1], (1, 2, 3))
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, w.to(x.dtype), b, stride=self.strides,
                                  padding=self.padding)


class _RefNorm(nn.Module):
    """GroupNorm with the reference's group rule and eps 1e-5 (image.py:
    293-299), statistics in float32, output in the input's dtype."""

    def __init__(self, channels: int, kind: str = "group", device=None):
        super().__init__()
        if kind != "group":
            raise NotImplementedError(
                f"norm {kind!r}: only group-norm scratch towers are ported "
                "yet (ROADMAP A.2.3)")
        self.GroupNorm_0 = nn.GroupNorm(max(channels // 16, 1), channels,
                                        eps=1e-5, device=device)

    def forward(self, x):
        return self.GroupNorm_0(x.to(torch.float32)).to(x.dtype)


class RefResBlock(nn.Module):
    """``ResBlock`` (image.py:128-189): two 3x3 convs (reflect-padded, or
    zero-padded transposed convs in the up path), each followed by norm +
    activation, the residual added after the last activation; a plain 1x1
    conv + norm shortcut when the widths differ."""

    def __init__(self, in_channels: int, features: int, norm: str = "group",
                 ws: bool = True, transpose: bool = False, device=None):
        super().__init__()
        self.ws = ws

        def conv(cin):
            if transpose:
                return WSConvTranspose2d(cin, features, 3, 1, 1,
                                         standardize=ws, device=device)
            return WSConv2d(cin, features, 3, 1, 1, "reflect",
                            standardize=ws, device=device)

        self.conv1 = conv(in_channels)
        self.norm1 = _RefNorm(features, norm, device=device)
        self.conv2 = conv(features)
        self.norm2 = _RefNorm(features, norm, device=device)
        if in_channels != features:
            self.down_conv = WSConv2d(in_channels, features, 1, 1, 0,
                                      standardize=False, device=device)
            self.down_norm = _RefNorm(features, norm, device=device)
        else:
            self.down_conv = None

    def forward(self, x):
        y = relu_ws(self.norm1(self.conv1(x)), self.ws)
        y = relu_ws(self.norm2(self.conv2(y)), self.ws)
        if self.down_conv is not None:
            x = self.down_norm(self.down_conv(x))
        return y + x


def _stride_out(nc_in: int, nc_out: int, strides: int, blocks: int) -> int:
    """The reference's width rule for the strided conv (image.py:324-333)."""
    return nc_in if strides > 1 and blocks > 0 else nc_out


class ResNetDown2D(nn.Module):
    """``ResNetDown`` (image.py:251-340): strided conv_in + norm + ReLUWS,
    then ``blocks`` ResBlocks.  ``in_channels`` is the width of the input
    (the config's ``nc_in`` sizes the strided conv's output only)."""

    def __init__(self, in_channels: int, nc_in: int, nc_out: int,
                 kernel_size: int = 2, strides: int = 2, padding: int = 0,
                 blocks: int = 1, norm: str = "group", ws: bool = True,
                 device=None):
        super().__init__()
        self.ws = ws
        c = _stride_out(nc_in, nc_out, strides, blocks)
        self.conv_in = WSConv2d(in_channels, c, kernel_size, strides, padding,
                                "reflect", standardize=ws, device=device)
        self.norm_in = _RefNorm(c, norm, device=device)
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"block{i}", RefResBlock(c, nc_out, norm, ws,
                                                   device=device))
            c = nc_out
        self.out_channels = c

    def forward(self, x):
        x = relu_ws(self.norm_in(self.conv_in(x)), self.ws)
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetUp2D(nn.Module):
    """``ResNetUp`` (image.py:343-400): transposed conv_in (even at stride
    1) + norm + ReLUWS, THEN the skip concat, then ``blocks`` transposed
    ResBlocks.  ``skip_channels`` is the width of the skip it receives (0:
    none)."""

    def __init__(self, in_channels: int, nc_in: int, nc_out: int,
                 skip_channels: int = 0, kernel_size: int = 2,
                 strides: int = 2, padding: int = 0, blocks: int = 1,
                 norm: str = "group", ws: bool = True, device=None):
        super().__init__()
        self.ws = ws
        c = _stride_out(nc_in, nc_out, strides, blocks)
        self.conv_in = WSConvTranspose2d(in_channels, c, kernel_size, strides,
                                         padding, standardize=ws,
                                         device=device)
        self.norm_in = _RefNorm(c, norm, device=device)
        c += skip_channels
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"block{i}", RefResBlock(
                c, nc_out, norm, ws, transpose=True, device=device))
            c = nc_out
        self.out_channels = c

    def forward(self, x, skip=None):
        x = relu_ws(self.norm_in(self.conv_in(x)), self.ws)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class UnaryConv2D(nn.Module):
    """``UnaryConv`` (image.py:403-456): a 1x1 conv (with bias) after an
    optional input channel dropout: ``Dropout2d`` (a mask per image) or,
    with ``persistent_drop``, ``PersistentDropout2d`` (one mask for the
    batch), fed by the generator :func:`image_encoders.run_tower` gets."""

    def __init__(self, in_channels: int, features: int, ws: bool = False,
                 in_drop: float = 0.0, persistent_drop: bool = False,
                 device=None):
        super().__init__()
        self.drop = (ChannelDropout(in_channels, in_drop,
                                    per_image=not persistent_drop)
                     if in_drop > 0 else None)
        self.conv = WSConv2d(in_channels, features, 1, 1, 0, standardize=ws,
                             device=device)

    def forward(self, x):
        if self.drop is not None:
            x = self.drop(x)
        return self.conv(x)


# compact tower config, the YAML DSL's shape (the JAX package's TowerCfg):
#   down: ((nc_in, nc_out, k, s, p, N), ...)
#   up:   ((nc_in, nc_skip, nc_out, k, s, p, N), ...)   or None
#   last: output_nc | (output_nc, in_drop, persistent_drop) | None


def tower_cfg_out_channels(cfg) -> int:
    """Output width of a compact tower: last conv if present, else the final
    up stage's nc_out, else the final down stage's nc_out."""
    down, up, last = cfg
    if last is not None:
        return int(last[0] if isinstance(last, (tuple, list)) else last)
    if up:
        return int(up[-1][2])
    return int(down[-1][1])


class UNetWS(nn.Module):
    """The reference's compact-format image ``UNet`` (image.py:510-627):
    ResNetDown stages (all but the last push a skip), ResNetUp stages
    popping skips (the last may get none), then an optional 1x1 ``last``
    conv."""

    def __init__(self, in_channels: int, down: Sequence[Tuple[int, ...]],
                 up: Optional[Sequence[Tuple[int, ...]]] = None, last=None,
                 norm: str = "group", ws: bool = True, device=None):
        super().__init__()
        self.n_down, self.n_up = len(down), len(up or ())
        c, skips = in_channels, []
        for i, (nc_in, nc_out, k, s, p, n_blk) in enumerate(down):
            stage = ResNetDown2D(c, nc_in, nc_out, k, s, p, n_blk, norm, ws,
                                 device=device)
            setattr(self, f"down{i}", stage)
            c = stage.out_channels
            if i < len(down) - 1:
                skips.append(c)
        for i, (nc_in, _, nc_out, k, s, p, n_blk) in enumerate(up or ()):
            stage = ResNetUp2D(c, nc_in, nc_out, skips.pop() if skips else 0,
                               k, s, p, n_blk, norm, ws, device=device)
            setattr(self, f"up{i}", stage)
            c = stage.out_channels
        self.last = None
        if last is not None:
            if isinstance(last, (tuple, list)):
                nc, in_drop, persist = last
                self.last = UnaryConv2D(c, int(nc), in_drop=float(in_drop),
                                        persistent_drop=bool(persist),
                                        device=device)
            else:
                self.last = UnaryConv2D(c, int(last), device=device)
            c = int(last[0] if isinstance(last, (tuple, list)) else last)
        self.out_channels = c

    def forward(self, x):
        skips = []
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x)
            if i < self.n_down - 1:
                skips.append(x)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x, skips.pop() if skips else None)
        if self.last is not None:
            x = self.last(x)
        return x


def unetws_from_cfg(cfg, norm: str = "group", ws: bool = True,
                    in_channels: int = 3, device=None) -> UNetWS:
    down, up, last = cfg
    return UNetWS(in_channels, tuple(map(tuple, down)),
                  tuple(map(tuple, up)) if up else None, last, norm, ws,
                  device=device)
