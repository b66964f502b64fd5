"""2D image towers: ResNet-18 with GroupNorm + weight standardization, or
with BatchNorm for converted pretrained weights.

The port of ``deepviewagg_tpu/modules/image_encoders.py`` (``Conv2dWS``,
``f32_convs``, ``run_tower``, ``_Norm``, ``_BasicBlock2d``, ``ResNet18``,
``PPM``, ``ResNet18PPM``, ``ResNet18Pyramid``, ``PersistentDropout2d``,
``UNet2D``, ``ConvDown2D``; the reference's
modules/multimodal/modalities/image.py).
Public tensors keep the JAX layout ``[I, W, H, C]`` (W before H); the
towers run channels-first ``[I, C, W, H]`` inside.  Sub-modules carry the
flax auto-names so :mod:`deepviewagg_tpu_torch.utils.from_jax` maps
parameters by name.  ``norm='group'`` (the from-scratch towers) pairs
GroupNorm with weight-standardized convs; ``norm='batch'`` (the towers that
take converted torchvision / MIT-semseg checkpoints,
:mod:`deepviewagg_tpu_torch.utils.pretrained`) is flax's ``BatchNorm``
(:class:`BatchNorm`) after plain convs.  A tower's channel dropouts
(:class:`ChannelDropout`) take masks that :func:`run_tower` draws from the
caller's generator before the tower runs, and its BatchNorms' running
statistics are written by :func:`run_tower` once per call, after the
forward.  :func:`run_tower` rematerializes the tower in the backward pass
(``remat``: all of it, or all but the convolutions' outputs; a memory saving
that changes no number) and freezes it (``frozen``); under
:func:`view_shard_group` it runs the tower on this rank's block of the
images and all-gathers the maps (view parallelism).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather_blocks

__all__ = ["BatchNorm", "Conv2dWS", "ResNet18", "PPM", "ResNet18PPM",
           "ResNet18Pyramid", "ChannelDropout", "PersistentDropout2d",
           "UNet2D", "ConvDown2D", "OUT_CHANNELS", "f32_convs", "run_tower",
           "view_shard_group"]

# channels of each tap level for ResNet18: stem, layer1..layer4 (the deep
# stem gives 128 at level 0)
OUT_CHANNELS = (64, 64, 128, 256, 512)

# Test-scoped switch: run every Conv2dWS with float32 operands (exact math)
# instead of the production bf16 operands.
_CONV_F32 = [False]


@contextlib.contextmanager
def f32_convs():
    """While active, every Conv2dWS uses float32 operands."""
    _CONV_F32.append(True)
    try:
        yield
    finally:
        _CONV_F32.pop()


# Step-scoped process group of VIEW PARALLELISM: while set, every tower runs
# only on this rank's block of the image axis and the feature maps are
# all-gathered back, so the 2D towers split over the group while the
# segment-structured 3D path stays replicated.  Same pattern as
# ``nn.norm.bn_process_group``.
_VIEW_SHARD_GROUP = [None]


@contextlib.contextmanager
def view_shard_group(group):
    """While active, shard every tower's image batch over the ranks of
    ``group`` (a ``torch.distributed`` group; None: no sharding)."""
    _VIEW_SHARD_GROUP.append(group)
    try:
        yield
    finally:
        _VIEW_SHARD_GROUP.pop()


class Conv2dWS(nn.Module):
    """Conv with weight standardization (zero-mean, unit-variance kernel per
    output channel, image.py:39-51); ``standardize=False`` (the BatchNorm
    towers) is the plain conv.  ``weight`` is the raw OIHW kernel over the
    channels-first ``[I, C, W, H]`` maps, so its dims 2 / 3 span W / H (a
    torch checkpoint's ``[O, I, kh, kw]`` is transposed to ``[O, I, kw,
    kh]``); standardization uses the biased variance, ``var * (kh*kw*cin) +
    1e-10``.  Padding is the torch convention (``k//2 * dilation`` per side);
    operands are bf16 (float32 under :func:`f32_convs`) and the output takes
    the input's dtype."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1),
                 standardize: bool = True, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.dilation = tuple(dilation)
        self.standardize = standardize
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, *self.kernel_size, device=device))

    def forward(self, x):
        kh, kw = self.kernel_size
        w = self.weight
        if self.standardize:
            mean = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            w = (w - mean) * torch.rsqrt(var * (kh * kw * w.shape[1]) + 1e-10)
        op_dt = torch.float32 if _CONV_F32[-1] else torch.bfloat16
        pad = (kh // 2 * self.dilation[0], kw // 2 * self.dilation[1])
        y = F.conv2d(x.to(op_dt), w.to(op_dt), stride=self.strides,
                     padding=pad, dilation=self.dilation)
        return y.to(x.dtype)


# the BatchNorms' running-statistics updates of the tower call in progress
# (see run_tower); None: a BatchNorm in training mode writes its own
_BN_UPDATES: list = [None]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis 1 of ``x [N, C, ...]``
    (float32): in training mode the batch statistics over every other axis
    (all images of the call, zero-padded slots included), the variance the
    biased ``E[x^2] - E[x]^2`` clipped at 0; in eval mode the running
    statistics.  ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``.
    The running statistics follow ``momentum * old + (1 - momentum) * new``
    with that biased variance (``torch.nn.BatchNorm2d`` keeps the unbiased
    one and takes ``1 - momentum``); a training-mode call inside
    :func:`run_tower` hands its update to the tower call, which applies it
    once, otherwise the call applies it.  No ``num_batches_tracked``."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x):
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            pending = _BN_UPDATES[-1]
            if pending is None:
                self.update(mean, var)
            else:
                pending.append((self, mean.detach(), var.detach()))
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


class _Norm(nn.Module):
    """flax ``GroupNorm`` (``kind='group'``: eps 1e-6; the group count
    shrinks until it divides C) or :class:`BatchNorm` (``kind='batch'``:
    momentum 0.9, eps 1e-5) with float32 statistics, output in the input
    dtype."""

    def __init__(self, channels: int, kind: str = "group",
                 num_groups: int = 16, device=None):
        super().__init__()
        if kind == "group":
            g = num_groups
            while channels % g:
                g -= 1
            self.GroupNorm_0 = nn.GroupNorm(g, channels, eps=1e-6,
                                            device=device)
        elif kind == "batch":
            self.BatchNorm_0 = BatchNorm(channels, device=device)
        else:
            raise ValueError(f"norm {kind!r}")
        self.kind = kind

    def forward(self, x):
        norm = self.GroupNorm_0 if self.kind == "group" else self.BatchNorm_0
        return norm(x.to(torch.float32)).to(x.dtype)


def _conv_norm(module: nn.Module, i: int, in_channels: int, features: int,
               norm: str, kernel=(3, 3), strides=(1, 1), dilation=(1, 1),
               device=None) -> None:
    """``Conv2dWS_<i>`` + ``_Norm_<i>`` on ``module``: weight-standardized
    under group norm, plain under batch norm."""
    setattr(module, f"Conv2dWS_{i}", Conv2dWS(
        in_channels, features, kernel, strides, dilation,
        standardize=norm == "group", device=device))
    setattr(module, f"_Norm_{i}", _Norm(features, norm, device=device))


class _BasicBlock2d(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1),
                 first_dilation: Optional[Tuple[int, int]] = None,
                 norm: str = "group", device=None):
        super().__init__()
        _conv_norm(self, 0, in_channels, features, norm, (3, 3), strides,
                   first_dilation or dilation, device)
        _conv_norm(self, 1, features, features, norm, (3, 3), (1, 1),
                   dilation, device)
        if in_channels != features or tuple(strides) != (1, 1):
            _conv_norm(self, 2, in_channels, features, norm, (1, 1), strides,
                       device=device)
        else:
            self.Conv2dWS_2 = None

    def forward(self, x):
        y = F.relu(self._Norm_0(self.Conv2dWS_0(x)))
        y = self._Norm_1(self.Conv2dWS_1(y))
        if self.Conv2dWS_2 is not None:
            x = self._Norm_2(self.Conv2dWS_2(x))
        return F.relu(y + x)


class ResNet18(nn.Module):
    """Torchvision-topology ResNet18 trunk (7x7 stem), truncated after
    ``out_level`` (0 stem .. 4 layer4); ``dilated8`` is the MIT-semseg
    stride-8 trunk with the ``_nostride_dilate`` first-conv rule.
    ``deep_stem`` is the MIT-semseg stem (the ADE20K / Cityscapes encoders):
    three 3x3 conv + norm + relu of ``width``, ``width`` and ``2 * width``
    channels (strides 2, 1, 1) in place of the 7x7, before the same max-pool;
    layer1's first block then projects its ``2 * width`` input channels.
    ``pyramid`` returns the list of every tap up to ``out_level`` (the
    max-pooled stem, then each layer) instead of the last one.  ``norm``:
    ``'group'`` or ``'batch'``.  Channels-first in and out."""

    def __init__(self, out_level: int = 4, dilated8: bool = False,
                 width: int = 64, deep_stem: bool = False,
                 pyramid: bool = False, norm: str = "group", device=None):
        super().__init__()
        self.pyramid = pyramid
        if deep_stem:
            stem = ((3, width, (2, 2)), (width, width, (1, 1)),
                    (width, width * 2, (1, 1)))
            for i, (cin, f, st) in enumerate(stem):
                _conv_norm(self, i, cin, f, norm, (3, 3), st, device=device)
        else:
            stem = ((3, width, (2, 2)),)
            _conv_norm(self, 0, 3, width, norm, (7, 7), (2, 2),
                       device=device)
        self.num_stem = len(stem)
        plan = [  # (features, first-stride, dilation) per layer
            (width, (1, 1), (1, 1)),
            (width * 2, (2, 2), (1, 1)),
            (width * 4, (1, 1) if dilated8 else (2, 2),
             (2, 2) if dilated8 else (1, 1)),
            (width * 8, (1, 1) if dilated8 else (2, 2),
             (4, 4) if dilated8 else (1, 1)),
        ]
        c, blocks = stem[-1][1], []
        self.tap_channels = [c]
        for f, s, d in plan[:out_level]:
            # MIT _nostride_dilate: the de-strided conv of a dilated stage
            # runs at d/2 — dilation 1 in layer3, 2 in layer4
            fd = (max(d[0] // 2, 1),) * 2 if d != (1, 1) else None
            blocks.append(_BasicBlock2d(c, f, s, d, first_dilation=fd,
                                        norm=norm, device=device))
            blocks.append(_BasicBlock2d(f, f, (1, 1), d, norm=norm,
                                        device=device))
            c = f
            self.tap_channels.append(c)
        for i, b in enumerate(blocks):
            setattr(self, f"_BasicBlock2d_{i}", b)
        self.num_blocks = len(blocks)
        self.out_channels = c

    def forward(self, x):
        for i in range(self.num_stem):
            x = F.relu(getattr(self, f"_Norm_{i}")(
                getattr(self, f"Conv2dWS_{i}")(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps = [x]
        for i in range(self.num_blocks):
            x = getattr(self, f"_BasicBlock2d_{i}")(x)
            if i % 2:
                taps.append(x)
        return taps if self.pyramid else x


def _avg_pool_same(x, window: Tuple[int, int]):
    """flax ``avg_pool(padding='SAME')`` with stride = window: zero padding
    split lo = total // 2, then a plain average over the full window."""
    pads = []
    for size, k in zip(x.shape[2:], window):
        out = -(-size // k)
        total = max((out - 1) * k + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (lo0, hi0), (lo1, hi1) = pads
    x = F.pad(x, (lo1, hi1, lo0, hi0))
    return F.avg_pool2d(x, window, stride=window)


class PPM(nn.Module):
    """Pyramid pooling feature head (``PPMFeatMap``, image.py:659-720):
    average pools at several bin counts -> 1x1 conv -> bilinear upsample ->
    concat with the trunk -> 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 bins: Sequence[int] = (1, 2, 3, 6), norm: str = "group",
                 device=None):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            _conv_norm(self, i, in_channels, out_channels, norm, (1, 1),
                       device=device)
        n = len(self.bins)
        _conv_norm(self, n, in_channels + n * out_channels, out_channels,
                   norm, (3, 3), device=device)

    def forward(self, x):
        h, w = x.shape[2:]
        feats = [x]
        for i, b in enumerate(self.bins):
            # float32 accumulation of the window sums
            pooled = _avg_pool_same(x.to(torch.float32),
                                    (-(-h // b), -(-w // b))).to(x.dtype)
            y = getattr(self, f"Conv2dWS_{i}")(pooled)
            y = F.relu(getattr(self, f"_Norm_{i}")(y))
            y = F.interpolate(y.to(torch.float32), size=(h, w),
                              mode="bilinear", align_corners=False)
            feats.append(y.to(x.dtype))
        n = len(self.bins)
        y = getattr(self, f"Conv2dWS_{n}")(torch.cat(feats, dim=1))
        return F.relu(getattr(self, f"_Norm_{n}")(y))


class ResNet18PPM(nn.Module):
    """Dilated-8 ResNet18 trunk + PPM (``ADE20KResNet18PPM``,
    image.py:721-792)."""

    def __init__(self, out_channels: int = 128, deep_stem: bool = False,
                 norm: str = "group", device=None):
        super().__init__()
        self.ResNet18_0 = ResNet18(out_level=4, dilated8=True,
                                   deep_stem=deep_stem, norm=norm,
                                   device=device)
        self.PPM_0 = PPM(self.ResNet18_0.out_channels, out_channels,
                         norm=norm, device=device)

    def forward(self, x):
        return self.PPM_0(self.ResNet18_0(x))


class ResNet18Pyramid(nn.Module):
    """Every trunk tap resized (bilinear, half-pixel centres) to the finest
    tap and concatenated: the single-map form of the reference's pyramid
    towers (``ADE20KResNet18Pyramid``, image.py:793-957), then, with
    ``project``, a 1x1 conv + norm + relu to ``out_channels``; without it
    the raw concat (the reference class's exact output: 1024 channels, 1088
    with the deep stem).  The taps are upsampled (the finest tap is the
    largest), so the flax resize's antialiasing does not act."""

    def __init__(self, out_channels: int = 128, deep_stem: bool = False,
                 project: bool = True, norm: str = "group", device=None):
        super().__init__()
        self.ResNet18_0 = ResNet18(out_level=4, deep_stem=deep_stem,
                                   pyramid=True, norm=norm, device=device)
        self.project = project
        c = sum(self.ResNet18_0.tap_channels)
        if project:
            _conv_norm(self, 0, c, out_channels, norm, (1, 1), device=device)
            c = out_channels
        self.out_channels = c

    def forward(self, x):
        taps = self.ResNet18_0(x)
        size = taps[0].shape[2:]
        # float32 interpolation, back to the activations' dtype (as PPM)
        y = torch.cat([taps[0]] + [
            F.interpolate(t.to(torch.float32), size=size, mode="bilinear",
                          align_corners=False).to(t.dtype)
            for t in taps[1:]], dim=1)
        if not self.project:
            return y
        return F.relu(self._Norm_0(self.Conv2dWS_0(y)))


class ChannelDropout(nn.Module):
    """Channel dropout with inverted scaling: ``Dropout2d`` (an independent
    channel mask per image, ``per_image``) or ``PersistentDropout2d`` (one
    mask for the whole image batch, image.py:465-508).  The boolean keep
    mask ``[I or 1, C, 1, 1]`` is set by :func:`run_tower`, drawn from the
    caller's generator in training; without one the module is the
    identity."""

    def __init__(self, channels: int, p: float = 0.5,
                 per_image: bool = False):
        super().__init__()
        self.channels = channels
        self.p = p
        self.per_image = per_image
        self.mask: Optional[torch.Tensor] = None

    def draw(self, generator: torch.Generator, n_images: int,
             device) -> torch.Tensor:
        shape = (n_images if self.per_image else 1, self.channels, 1, 1)
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u.to(device) >= self.p

    def forward(self, x):
        if self.mask is None:
            return x
        return torch.where(self.mask, x / (1.0 - self.p), 0.0)


def PersistentDropout2d(channels: int, p: float = 0.5) -> ChannelDropout:
    """One channel mask shared by every image of the batch (ref
    ``PersistentDropout2d``)."""
    return ChannelDropout(channels, p, per_image=False)


class UNet2D(nn.Module):
    """Configurable 2D UNet tower (the reference's generic image ``UNet``,
    image.py:510-657): per down stage a 3x3 conv (stride 1, then 2) + norm +
    relu + basic block, per up stage a bilinear resize to the skip's size,
    the skip concat, a 3x3 conv + norm + relu + basic block, then (with
    ``dropout``) a persistent channel dropout and a 3x3 conv + norm + relu
    to ``out_channels``.  Feature maps at the input's resolution."""

    def __init__(self, in_channels: int = 3,
                 down_widths: Sequence[int] = (32, 64, 128),
                 up_widths: Sequence[int] = (64, 32), out_channels: int = 32,
                 dropout: float = 0.0, norm: str = "group", device=None):
        super().__init__()
        self.n_down, self.n_up = len(down_widths), len(up_widths)
        c, skips, i = in_channels, [], 0
        for k, w in enumerate(down_widths):
            _conv_norm(self, i, c, w, norm, (3, 3),
                       (1, 1) if k == 0 else (2, 2), device=device)
            setattr(self, f"_BasicBlock2d_{i}",
                    _BasicBlock2d(w, w, norm=norm, device=device))
            c, i = w, i + 1
            if k < self.n_down - 1:
                skips.append(c)
        for w in up_widths:
            _conv_norm(self, i, c + skips.pop(), w, norm, device=device)
            setattr(self, f"_BasicBlock2d_{i}",
                    _BasicBlock2d(w, w, norm=norm, device=device))
            c, i = w, i + 1
        self.drop = PersistentDropout2d(c, dropout) if dropout > 0 else None
        _conv_norm(self, i, c, out_channels, norm, device=device)
        self.out_channels = out_channels

    def _stage(self, i, x):
        x = F.relu(getattr(self, f"_Norm_{i}")(
            getattr(self, f"Conv2dWS_{i}")(x)))
        return getattr(self, f"_BasicBlock2d_{i}")(x)

    def forward(self, x):
        skips = []
        for i in range(self.n_down):
            x = self._stage(i, x)
            if i < self.n_down - 1:
                skips.append(x)
        for i in range(self.n_down, self.n_down + self.n_up):
            skip = skips.pop()
            # float32 interpolation, back to the activations' dtype (as PPM)
            x = F.interpolate(x.to(torch.float32), size=skip.shape[2:],
                              mode="bilinear", align_corners=False)
            x = self._stage(i, torch.cat([x.to(skip.dtype), skip], dim=1))
        if self.drop is not None:
            x = self.drop(x)
        i = self.n_down + self.n_up
        return F.relu(getattr(self, f"_Norm_{i}")(
            getattr(self, f"Conv2dWS_{i}")(x)))


class ConvDown2D(nn.Module):
    """Configurable GN+WS conv-ResBlock trunk with per-stage taps (the JAX
    ``ConvDown2D``): the reference's generic ``ResNetDown`` image encoder as
    the Res16Image families configure it (``image.down_conv``: per-stage
    out widths, residual-block counts and strides; GroupNorm + weight
    standardization).  Stage ``i`` is ``stage{i}_conv`` (3x3, its stride) +
    ``stage{i}_norm`` + relu, then ``stage{i}_block{b}`` basic blocks.
    Returns the TUPLE of per-stage maps, so one trunk feeds gather/pool
    taps at successive 3D levels.  Channels-first in and out."""

    def __init__(self, widths: Sequence[int] = (32, 32, 64, 128, 256),
                 blocks: Sequence[int] = (0, 2, 2, 2, 2),
                 strides: Sequence[int] = (1, 2, 2, 2, 2),
                 norm: str = "group", in_channels: int = 3, device=None):
        super().__init__()
        self.plan = tuple(zip(widths, blocks, strides))
        c = in_channels
        for i, (w, n, s) in enumerate(self.plan):
            setattr(self, f"stage{i}_conv", Conv2dWS(
                c, w, (3, 3), (s, s), standardize=norm == "group",
                device=device))
            setattr(self, f"stage{i}_norm", _Norm(w, norm, device=device))
            for b in range(n):
                setattr(self, f"stage{i}_block{b}",
                        _BasicBlock2d(w, w, norm=norm, device=device))
            c = w
        self.tap_channels = tuple(int(w) for w in widths)

    def forward(self, x):
        taps = []
        for i, (_, n, _) in enumerate(self.plan):
            x = F.relu(getattr(self, f"stage{i}_norm")(
                getattr(self, f"stage{i}_conv")(x)))
            for b in range(n):
                x = getattr(self, f"stage{i}_block{b}")(x)
            taps.append(x)
        return tuple(taps)


def _save_only_convs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat='convs'``: the outputs of the
    convolutions are kept, everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _shard_block(x, masks, group):
    """This rank's block of the images ``x [I, C, W, H]`` (zero-padded to
    an even split over ``group``) and of the per-image dropout masks."""
    m, k = dist.get_world_size(group), dist.get_rank(group)
    n_img = x.shape[0]
    blk = -(-n_img // m)

    def block(t, fill):
        if t is None or (t.shape[0] == 1 and n_img != 1):
            return t     # no mask, or one mask for every image
        if blk * m != n_img:
            pad = t.new_full((blk * m - n_img,) + t.shape[1:], fill)
            t = torch.cat([t, pad])
        return t[k * blk:(k + 1) * blk]

    return block(x, 0), [block(mask, True) for mask in masks]


def run_tower(tower: nn.Module, images: torch.Tensor, train: bool = False, *,
              remat=False, frozen: bool = False, bf16: bool = True,
              out_f32: bool = True,
              generator: Optional[torch.Generator] = None):
    """Tower driver of the branch: ``images [I, W, H, 3]`` ->
    ``[I, Wf, Hf, C]``, or the tuple of such maps of a tower that returns
    several taps (:class:`ConvDown2D`).  ``bf16`` runs the activations in
    bf16 (parameters and conv accumulation stay float32); every output is
    float32 unless ``out_f32`` is False.

    ``remat`` is ``False`` (autograd keeps every activation), ``True`` (the
    backward pass runs the whole tower forward again: one more tower forward
    of work, only the input kept) or ``'convs'`` (the outputs of the
    convolutions are kept and only the weight standardization, norm, relu
    and pooling around them are recomputed); it changes no number.
    ``frozen`` runs the tower in eval mode (``train and not frozen``) outside
    autograd, so the output is detached, nothing is kept for a backward
    pass and the BatchNorms use and keep their running statistics; remat is
    then skipped.  ``generator`` feeds the tower's channel dropouts in
    training (their masks are drawn before the tower runs, so a
    rematerialized forward applies the same ones).

    In training mode every :class:`BatchNorm` normalizes with its batch
    statistics and its running statistics move exactly once per call, from
    the first forward, after the tower has run: a rematerialized forward in
    the backward pass (``torch.utils.checkpoint`` runs the BatchNorms again
    under ``'convs'`` too) collects its statistics and drops them, as flax's
    ``nn.remat`` updates ``batch_stats`` once.

    Under an active :func:`view_shard_group` of ``m`` ranks, the ``I``
    images are zero-padded to ``m * ceil(I / m)`` and each rank runs the
    tower on its block of ``ceil(I / m)`` (its block of the dropout masks,
    which are drawn for all ``I`` images); the maps come back in rank order
    through an all-gather, trimmed to ``I``.  The gather's backward is a
    reduce-scatter, so each rank's tower gradient arrives ``m``-fold (see
    ``parallel.mesh.hybrid_parallel_step``); a frozen tower gathers outside
    autograd."""
    if remat not in (False, True, "convs"):
        # a typo like 'conv' would otherwise silently select FULL remat
        raise ValueError(f"remat must be False, True or 'convs'; got {remat!r}")
    if bf16:
        images = images.to(torch.bfloat16)
    x = images.permute(0, 3, 1, 2)
    n_img = x.shape[0]
    mode = train and not frozen
    drops = [m for m in tower.modules()
             if isinstance(m, ChannelDropout) and m.p > 0]
    masks = [None] * len(drops)
    if drops and generator is not None and mode:
        masks = [m.draw(generator, n_img, x.device) for m in drops]
    group = _VIEW_SHARD_GROUP[-1]
    if group is not None:
        x, masks = _shard_block(x, masks, group)
    runs = []      # the BatchNorm updates of each run of ``call``

    def call(x, *masks):
        for m, mask in zip(drops, masks):
            m.mask = mask
        was_training = tower.training
        tower.train(mode)
        updates = []
        _BN_UPDATES.append(updates)
        try:
            y = tower(x)
        finally:
            _BN_UPDATES.pop()
            tower.train(was_training)
            for m in drops:
                m.mask = None
        runs.append(updates)
        return y

    if frozen:
        with torch.no_grad():
            y = call(x, *masks)
    elif remat and torch.is_grad_enabled():
        from torch.utils import checkpoint as ckpt

        # the towers draw nothing themselves: their dropout masks are
        # arguments of the checkpointed call
        kw = {"preserve_rng_state": False}
        if remat == "convs":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_only_convs)
        y = ckpt.checkpoint(call, x, *masks, use_reentrant=False, **kw)
    else:
        y = call(x, *masks)
    for bn, mean, var in runs[0]:
        bn.update(mean, var)
    if group is not None:
        def gather(t):
            return all_gather_blocks(t, group)[:n_img]

        with torch.no_grad() if frozen else contextlib.nullcontext():
            y = tuple(map(gather, y)) if isinstance(y, tuple) else gather(y)

    def channels_last(t):
        t = t.permute(0, 2, 3, 1)
        return (t.to(torch.float32) if out_f32 else t).contiguous()

    if isinstance(y, tuple):
        return tuple(channels_last(t) for t in y)
    return channels_last(y)
