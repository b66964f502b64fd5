"""Load the JAX package's flax variables into the port's modules.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (``jax.device_get`` of what ``model.init`` returns).  The port's
sub-modules carry the flax names (``Conv2dWS_0``, ``_Norm_1/GroupNorm_0``,
``SparseConvNormRelu_0/SparseConv_0``, ``MaskedBatchNorm_0``, ``Dense_0``,
``e_score``, ``head`` ...), so every flax leaf path names the torch module it
belongs to; the module's type decides the leaf's name and layout:

  Dense ``kernel [in, out]``          -> ``nn.Linear.weight [out, in]``
  Conv2dWS ``kernel`` HWIO            -> ``Conv2dWS.weight`` OIHW (raw: the
                                         standardization runs in forward)
  SparseConv ``kernel [K, Cin, Cout]`` -> ``SparseConv.weight`` as is
  ``scale`` / ``bias`` of norms       -> ``weight`` / ``bias``
  ``batch_stats`` ``mean`` / ``var``  -> ``running_mean`` / ``running_var``

The load is strict: every flax leaf is consumed exactly once and every torch
parameter and buffer is filled exactly once, or it raises.  Nothing depends
on parameter order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_variables", "flatten"]


def flatten(tree: Mapping, prefix=()):
    """``{(key, ..., leaf): array}`` of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _convert(module: nn.Module, collection: str, leaf: str, value: np.ndarray):
    """(torch attribute name, converted array) of one flax leaf."""
    from ..modules.image_encoders import Conv2dWS
    from ..modules.pooling import Gating
    from ..nn.norm import MaskedBatchNorm
    from ..nn.sparse_blocks import SparseConv

    if collection == "batch_stats":
        if isinstance(module, MaskedBatchNorm) and leaf in ("mean", "var"):
            return "running_" + leaf, value
    elif collection == "params":
        if isinstance(module, nn.Linear):
            if leaf == "kernel":
                return "weight", value.T
            if leaf == "bias":
                return "bias", value
        elif isinstance(module, Conv2dWS) and leaf == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        elif isinstance(module, SparseConv) and leaf == "kernel":
            return "weight", value
        elif isinstance(module, (MaskedBatchNorm, nn.GroupNorm)):
            if leaf in ("scale", "bias"):
                return {"scale": "weight", "bias": "bias"}[leaf], value
        elif isinstance(module, Gating) and leaf in ("weight", "bias"):
            return leaf, value
    raise KeyError(f"no rule for {collection} leaf {leaf!r} of "
                   f"{type(module).__name__}")


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Copy flax ``variables`` into ``model`` (strict, by name)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for (collection, *path, leaf), value in flatten(variables).items():
        where = "/".join([collection, *path, leaf])
        try:
            module = model.get_submodule(".".join(path))
        except AttributeError as e:
            raise KeyError(f"{where}: no torch module at {'.'.join(path)!r}") from e
        name, arr = _convert(module, collection, leaf, np.asarray(value))
        key = ".".join([*path, name])
        if key not in targets:
            raise KeyError(f"{where}: torch model has no {key!r}")
        if key in filled:
            raise KeyError(f"{where}: {key!r} filled twice")
        dst = targets[key]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{where}: shape {tuple(arr.shape)} does not fit "
                             f"{key!r} {tuple(dst.shape)}")
        dst.copy_(torch.as_tensor(np.ascontiguousarray(arr), dtype=dst.dtype))
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"torch entries not filled from flax: {missing}")
