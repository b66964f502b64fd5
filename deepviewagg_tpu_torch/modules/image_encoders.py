"""2D image towers: ResNet-18 with GroupNorm + weight standardization.

The port of ``deepviewagg_tpu/modules/image_encoders.py`` (``Conv2dWS``,
``f32_convs``, ``run_tower``, ``_Norm``, ``_BasicBlock2d``, ``ResNet18``,
``PPM``, ``ResNet18PPM``; the reference's modules/multimodal/modalities/
image.py).  Public tensors keep the JAX layout ``[I, W, H, C]`` (W before H);
the towers run channels-first ``[I, C, W, H]`` inside.  Sub-modules carry the
flax auto-names so :mod:`deepviewagg_tpu_torch.utils.from_jax` maps
parameters by name.  Only ``norm='group'`` (the from-scratch towers) is
ported: it has no batch statistics, so the towers compute the same in
training and eval mode and differentiate by ordinary autograd.
:func:`run_tower` rematerializes the tower in the backward pass (``remat``:
all of it, or all but the convolutions' outputs; a memory saving that changes
no number) and freezes it (``frozen``).  View sharding is not ported.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2dWS", "ResNet18", "PPM", "ResNet18PPM", "OUT_CHANNELS",
           "f32_convs", "run_tower"]

# channels of each tap level for ResNet18: stem, layer1..layer4
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


class Conv2dWS(nn.Module):
    """Conv with weight standardization (zero-mean, unit-variance kernel per
    output channel, image.py:39-51).  ``weight`` is the raw OIHW kernel;
    standardization uses the biased variance, ``var * (kh*kw*cin) + 1e-10``.
    Padding is the torch convention (``k//2 * dilation`` per side); operands
    are bf16 (float32 under :func:`f32_convs`) and the output takes the
    input's dtype."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.dilation = tuple(dilation)
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, *self.kernel_size, device=device))

    def forward(self, x):
        kh, kw = self.kernel_size
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) * torch.rsqrt(var * (kh * kw * w.shape[1]) + 1e-10)
        op_dt = torch.float32 if _CONV_F32[-1] else torch.bfloat16
        pad = (kh // 2 * self.dilation[0], kw // 2 * self.dilation[1])
        y = F.conv2d(x.to(op_dt), w.to(op_dt), stride=self.strides,
                     padding=pad, dilation=self.dilation)
        return y.to(x.dtype)


class _Norm(nn.Module):
    """flax ``GroupNorm`` (eps 1e-6; the group count shrinks until it
    divides C) with float32 statistics, output in the input dtype."""

    def __init__(self, channels: int, num_groups: int = 16, device=None):
        super().__init__()
        g = num_groups
        while channels % g:
            g -= 1
        self.GroupNorm_0 = nn.GroupNorm(g, channels, eps=1e-6, device=device)

    def forward(self, x):
        return self.GroupNorm_0(x.to(torch.float32)).to(x.dtype)


class _BasicBlock2d(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1),
                 first_dilation: Optional[Tuple[int, int]] = None,
                 device=None):
        super().__init__()
        self.Conv2dWS_0 = Conv2dWS(in_channels, features, (3, 3), strides,
                                   first_dilation or dilation, device=device)
        self._Norm_0 = _Norm(features, device=device)
        self.Conv2dWS_1 = Conv2dWS(features, features, (3, 3), (1, 1),
                                   dilation, device=device)
        self._Norm_1 = _Norm(features, device=device)
        if in_channels != features or tuple(strides) != (1, 1):
            self.Conv2dWS_2 = Conv2dWS(in_channels, features, (1, 1), strides,
                                       device=device)
            self._Norm_2 = _Norm(features, device=device)
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
    Channels-first in and out."""

    def __init__(self, out_level: int = 4, dilated8: bool = False,
                 width: int = 64, device=None):
        super().__init__()
        self.Conv2dWS_0 = Conv2dWS(3, width, (7, 7), (2, 2), device=device)
        self._Norm_0 = _Norm(width, device=device)
        plan = [  # (features, first-stride, dilation) per layer
            (width, (1, 1), (1, 1)),
            (width * 2, (2, 2), (1, 1)),
            (width * 4, (1, 1) if dilated8 else (2, 2),
             (2, 2) if dilated8 else (1, 1)),
            (width * 8, (1, 1) if dilated8 else (2, 2),
             (4, 4) if dilated8 else (1, 1)),
        ]
        c, blocks = width, []
        for f, s, d in plan[:out_level]:
            # MIT _nostride_dilate: the de-strided conv of a dilated stage
            # runs at d/2 — dilation 1 in layer3, 2 in layer4
            fd = (max(d[0] // 2, 1),) * 2 if d != (1, 1) else None
            blocks.append(_BasicBlock2d(c, f, s, d, first_dilation=fd,
                                        device=device))
            blocks.append(_BasicBlock2d(f, f, (1, 1), d, device=device))
            c = f
        for i, b in enumerate(blocks):
            setattr(self, f"_BasicBlock2d_{i}", b)
        self.num_blocks = len(blocks)
        self.out_channels = c

    def forward(self, x):
        x = F.relu(self._Norm_0(self.Conv2dWS_0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.num_blocks):
            x = getattr(self, f"_BasicBlock2d_{i}")(x)
        return x


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
                 bins: Sequence[int] = (1, 2, 3, 6), device=None):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            setattr(self, f"Conv2dWS_{i}", Conv2dWS(
                in_channels, out_channels, (1, 1), device=device))
            setattr(self, f"_Norm_{i}", _Norm(out_channels, device=device))
        n = len(self.bins)
        setattr(self, f"Conv2dWS_{n}", Conv2dWS(
            in_channels + n * out_channels, out_channels, (3, 3),
            device=device))
        setattr(self, f"_Norm_{n}", _Norm(out_channels, device=device))

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

    def __init__(self, out_channels: int = 128, device=None):
        super().__init__()
        self.ResNet18_0 = ResNet18(out_level=4, dilated8=True, device=device)
        self.PPM_0 = PPM(self.ResNet18_0.out_channels, out_channels,
                         device=device)

    def forward(self, x):
        return self.PPM_0(self.ResNet18_0(x))


def _save_only_convs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat='convs'``: the outputs of the
    convolutions are kept, everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_tower(tower: nn.Module, images: torch.Tensor, train: bool = False, *,
              remat=False, frozen: bool = False, bf16: bool = True,
              out_f32: bool = True) -> torch.Tensor:
    """Tower driver of the branch: ``images [I, W, H, 3]`` ->
    ``[I, Wf, Hf, C]``.  ``bf16`` runs the activations in bf16 (parameters
    and conv accumulation stay float32); the output is float32 unless
    ``out_f32`` is False.

    ``remat`` is ``False`` (autograd keeps every activation), ``True`` (the
    backward pass runs the whole tower forward again: one more tower forward
    of work, only the input kept) or ``'convs'`` (the outputs of the
    convolutions are kept and only the weight standardization, norm, relu
    and pooling around them are recomputed); it changes no number.
    ``frozen`` runs the tower in eval mode (``train and not frozen``) outside
    autograd, so the output is detached and nothing is kept for a backward
    pass; remat is then skipped."""
    if remat not in (False, True, "convs"):
        # a typo like 'conv' would otherwise silently select FULL remat
        raise ValueError(f"remat must be False, True or 'convs'; got {remat!r}")
    if bf16:
        images = images.to(torch.bfloat16)
    x = images.permute(0, 3, 1, 2)
    was_training = tower.training
    tower.train(train and not frozen)
    try:
        if frozen:
            with torch.no_grad():
                y = tower(x)
        elif remat and torch.is_grad_enabled():
            from torch.utils import checkpoint as ckpt

            kw = {"preserve_rng_state": False}    # the towers draw nothing
            if remat == "convs":
                kw["context_fn"] = functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    _save_only_convs)
            y = ckpt.checkpoint(tower, x, use_reentrant=False, **kw)
        else:
            y = tower(x)
    finally:
        tower.train(was_training)
    y = y.permute(0, 2, 3, 1)
    if out_f32:
        y = y.to(torch.float32)
    return y.contiguous()
