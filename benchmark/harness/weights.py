"""Seeded weights, made on the device in one draw.

Every parameter takes its slice of one normal draw of a ``torch.Generator``
on the model's device, scaled by its kind: He-normal for convolution
kernels (fan in: the kernel's input channels times its taps), LeCun-normal
for linear weights (fan in: input features), zero biases, unit scales.
Running statistics keep their construction values (mean 0, variance 1).
The same initial values go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["seeded_state"]


def _std(shape) -> float:
    if len(shape) == 4:                       # 2D conv [O, I, kw, kh]
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    if len(shape) == 3:                       # sparse conv [K, Cin, Cout]
        return math.sqrt(2.0 / (shape[0] * shape[1]))
    return math.sqrt(1.0 / shape[1])          # linear [out, in]


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Write seeded values into ``model``'s parameters; return its whole
    state (parameters and buffers) as host copies."""
    params = list(model.named_parameters())
    device = params[0][1].device
    total = sum(p.numel() for _, p in params if p.ndim >= 2)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    draw = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, p in params:
        if p.ndim >= 2:
            n = p.numel()
            p.copy_(draw[at:at + n].view_as(p) * _std(p.shape))
            at += n
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    del draw
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
