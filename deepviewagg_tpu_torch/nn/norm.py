"""Validity-masked batch normalization.

The port of ``deepviewagg_tpu/nn/norm.py`` (``MaskedBatchNorm``,
``bn_momentum``): the reference normalizes sparse-voxel features with
BatchNorm over active voxels; the static-shape sparse tensors carry padding
rows, so the training statistics are taken over *valid* rows only.  In eval
mode the layer applies its running statistics (``running_mean`` /
``running_var`` buffers, the flax ``batch_stats`` ``mean`` / ``var``) with
eps 1e-5 in float32.  Under :func:`bn_process_group` the statistics are
summed over the ranks of a process group (sync BN, the JAX
``bn_axis_name``).

``PointBatchNorm`` is Pointcept's: ``torch.nn.BatchNorm1d`` over the rows
of ``[N, C]`` or the ``N x S`` rows of ``[N, S, C]`` (Point Transformer
V2's neighbour tensors), through ``F.batch_norm``, which keeps only its
input for the backward pass.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum

__all__ = ["MaskedBatchNorm", "PointBatchNorm", "bn_momentum",
           "bn_process_group"]

# Step-scoped process group for cross-device (sync) batch norm: set by the
# parallel step wrappers (parallel/mesh.py) so that every MaskedBatchNorm of
# the model sums its statistics over it without threading a field through
# all modules.  None: this rank's statistics alone.
_BN_GROUP = [None]

# Trainer-scoped momentum override: the reference's BN-momentum scheduler
# (core/schedulers/bn_schedulers.py) decays momentum across epochs.
_BN_MOMENTUM = [None]


@contextlib.contextmanager
def bn_process_group(group):
    """While active, every MaskedBatchNorm in training mode sums its
    statistics ``s1``, ``s2`` and ``n`` over the ranks of ``group`` (a
    ``torch.distributed`` group object, e.g. ``dist.group.WORLD``; None:
    no sync), through a differentiable all-reduce."""
    _BN_GROUP.append(group)
    try:
        yield
    finally:
        _BN_GROUP.pop()


@contextlib.contextmanager
def bn_momentum(value: Optional[float]):
    """While active, every MaskedBatchNorm uses this momentum."""
    _BN_MOMENTUM.append(value)
    try:
        yield
    finally:
        _BN_MOMENTUM.pop()


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the row axis of ``x [N, C]`` with a validity mask
    ``valid bool [N]`` (None: all rows).

    In training mode the batch statistics are masked sums with the *biased*
    variance, and the running statistics follow ``momentum * old +
    (1 - momentum) * new`` with that same biased variance (unlike
    ``torch.nn.BatchNorm1d``, whose running variance is unbiased); the
    buffers are updated in place.  ``momentum`` follows the torch default
    the reference uses (running = 0.9 * old + 0.1 * new)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, valid=None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            if valid is None:
                w = xf.new_ones(xf.shape[:-1] + (1,))
            else:
                w = valid.to(torch.float32).reshape(valid.shape + (1,))
            rows = tuple(range(xf.ndim - 1))
            s1 = torch.sum(xf * w, dim=rows)
            s2 = torch.sum(xf * xf * w, dim=rows)
            n = torch.sum(w)
            group = _BN_GROUP[-1]
            if group is not None:
                # one all-reduce of [s1, s2, n]: its backward sums the
                # cotangents over the ranks, as psum's transpose does
                c = s1.shape[0]
                sums = all_reduce_sum(torch.cat([s1, s2, n.reshape(1)]),
                                      group)
                s1, s2, n = sums[:c], sums[c:2 * c], sums[2 * c]
            n = torch.clamp(n, min=1.0)
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            mom = (self.momentum if _BN_MOMENTUM[-1] is None
                   else _BN_MOMENTUM[-1])
            with torch.no_grad():
                self.running_mean.mul_(mom).add_(mean, alpha=1 - mom)
                self.running_var.mul_(mom).add_(var, alpha=1 - mom)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


class PointBatchNorm(nn.Module):
    """``torch.nn.BatchNorm1d`` (eps 1e-5, momentum 0.1, the unbiased
    variance in the running statistics) over every row of ``x [..., C]``:
    the ``N x S`` rows of ``[N, S, C]`` as Pointcept's ``PointBatchNorm``
    takes them.  The statistics are float32 whatever ``x``'s type; the
    output comes out in ``x``'s type (a bfloat16 ``x`` gives a bfloat16
    output, rounded once from the float32 result), or in ``dtype`` where
    given.  Every row counts: the caller leaves padding rows out."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        if dtype is not None and dtype != x.dtype:
            x = x.to(dtype)
        c = x.shape[-1]
        y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         self.training, 0.1, 1e-5)
        return y.view(x.shape)
