"""Move variables between the JAX package's flax trees and the port's modules:
:func:`load_flax_variables` fills a model from a flax tree, and
:func:`to_flax_tree` is the inverse walk (parameters, their gradients or the
running statistics as a flax-layout tree of numpy arrays).

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (``jax.device_get`` of what ``model.init`` returns).  The port's
sub-modules carry the flax names (``Conv2dWS_0``, ``_Norm_1/GroupNorm_0``,
``SparseConvNormRelu_0/SparseConv_0``, ``MaskedBatchNorm_0``, ``Dense_0``,
``e_score``, ``head`` ...), so every flax leaf path names the torch module it
belongs to; the module's type decides the leaf's name and layout:

  Dense ``kernel [in, out]``          -> ``nn.Linear.weight [out, in]``
  Conv2dWS ``kernel`` HWIO            -> ``Conv2dWS.weight`` OIHW (raw: the
                                         standardization runs in forward)
  scratch ``WSConv2d`` ``kernel`` HWIO -> ``weight`` OIHW, ``bias`` as is
  ``WSConvTranspose2d`` ``kernel``      -> ``weight [in, out, kh, kw]``
    ``[kh, kw, in, out]``                  (unflipped: the JAX module flips
                                         it to run a dilated-input conv,
                                         ``conv_transpose2d`` takes it as is)
  SparseConv ``kernel [K, Cin, Cout]`` -> ``SparseConv.weight`` as is
  ``scale`` / ``bias`` of norms       -> ``weight`` / ``bias``
  ``batch_stats`` ``mean`` / ``var``  -> ``running_mean`` / ``running_var``
    (``MaskedBatchNorm`` and the towers' ``BatchNorm``)

The load is strict: every flax leaf is consumed exactly once and every torch
parameter and buffer is filled exactly once, or it raises.  Nothing depends
on parameter order.  Several branches at one level (``branch_l0``,
``branch_l0_1`` .. as both packages' ``MultimodalSeg`` name them, the
KITTI-360 PointPyramid's five) map by those names both ways, as do the no3d
and late-fusion families' ``branch``, ``branch_<k>``, ``backbone``,
``head``, ``head3d``, ``head2d[_<k>]`` and ``mix``, the QKV pool's
``e_main`` / ``key_enc`` / ``e_mod`` / ``e_mix_k`` / ``e_mix_q`` / ``q`` /
``k``, the scratch towers' ``down<i>`` / ``up<i>`` / ``last``, the shared
trunk's ``shared_tower/stage<i>_conv`` / ``stage<i>_norm`` /
``stage<i>_block<b>`` and the reused tower's ``reuse_tower/...`` (a
tower-less, shared-tap or reuse branch owns no ``tower``); a branch's
crop-ladder wrapper is not a module and owns no parameter.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_variables", "to_flax_tree", "flatten"]


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
    from ..modules.image_encoders import BatchNorm, Conv2dWS
    from ..modules.pooling import Gating
    from ..modules.scratch2d import WSConv2d, WSConvTranspose2d
    from ..nn.norm import MaskedBatchNorm
    from ..nn.sparse_blocks import SparseConv

    if collection == "batch_stats":
        if isinstance(module, (MaskedBatchNorm, BatchNorm)) and leaf in (
                "mean", "var"):
            return "running_" + leaf, value
    elif collection == "params":
        if isinstance(module, nn.Linear):
            if leaf == "kernel":
                return "weight", value.T
            if leaf == "bias":
                return "bias", value
        elif isinstance(module, Conv2dWS) and leaf == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        elif isinstance(module, (WSConv2d, WSConvTranspose2d)):
            if leaf == "bias":
                return "bias", value
            if leaf == "kernel":
                return "weight", value.transpose(
                    (3, 2, 0, 1) if isinstance(module, WSConv2d)
                    else (2, 3, 0, 1))
        elif isinstance(module, SparseConv) and leaf == "kernel":
            return "weight", value
        elif isinstance(module, (MaskedBatchNorm, BatchNorm, nn.GroupNorm)):
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


def _unconvert(module: nn.Module, name: str, value: np.ndarray):
    """(flax leaf name, flax-layout array) of one torch parameter or buffer:
    the inverse of :func:`_convert`."""
    from ..modules.image_encoders import BatchNorm, Conv2dWS
    from ..modules.pooling import Gating
    from ..modules.scratch2d import WSConv2d, WSConvTranspose2d
    from ..nn.norm import MaskedBatchNorm
    from ..nn.sparse_blocks import SparseConv

    if isinstance(module, (MaskedBatchNorm, BatchNorm)) and name.startswith(
            "running_"):
        return name[len("running_"):], value
    if isinstance(module, nn.Linear):
        if name == "weight":
            return "kernel", value.T
        if name == "bias":
            return "bias", value
    elif isinstance(module, Conv2dWS) and name == "weight":
        return "kernel", value.transpose(2, 3, 1, 0)
    elif isinstance(module, (WSConv2d, WSConvTranspose2d)):
        if name == "bias":
            return "bias", value
        if name == "weight":
            return "kernel", value.transpose(
                (2, 3, 1, 0) if isinstance(module, WSConv2d) else (2, 3, 0, 1))
    elif isinstance(module, SparseConv) and name == "weight":
        return "kernel", value
    elif isinstance(module, (MaskedBatchNorm, BatchNorm, nn.GroupNorm)):
        if name in ("weight", "bias"):
            return {"weight": "scale", "bias": "bias"}[name], value
    elif isinstance(module, Gating) and name in ("weight", "bias"):
        return name, value
    raise KeyError(f"no rule for {name!r} of {type(module).__name__}")


def to_flax_tree(model: nn.Module, what: str = "params") -> dict:
    """The model's ``"params"``, their ``"grads"`` or its ``"batch_stats"``
    as a nested dict of numpy arrays in flax layout under flax paths.
    Strict: every parameter (buffer) is written exactly once, a missing
    gradient raises."""
    if what in ("params", "grads"):
        items = model.named_parameters()
    elif what == "batch_stats":
        items = model.named_buffers()
    else:
        raise ValueError(what)
    tree: dict = {}
    for key, tensor in items:
        *path, name = key.split(".")
        if what == "grads":
            if tensor.grad is None:
                raise KeyError(f"{key!r} has no gradient")
            tensor = tensor.grad
        leaf, arr = _unconvert(model.get_submodule(".".join(path)), name,
                               tensor.detach().cpu().numpy())
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf in node:
            raise KeyError(f"{key!r}: flax leaf {leaf!r} written twice")
        node[leaf] = np.ascontiguousarray(arr)
    return tree
