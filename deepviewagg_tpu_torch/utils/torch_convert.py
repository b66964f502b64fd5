"""Map torch ResNet-18 checkpoints onto the port's BatchNorm towers.

The port of ``deepviewagg_tpu/utils/torch_convert.py``.  The reference
consumes pretrained 2D towers (torchvision ImageNet ResNet18, MIT-semseg
ADE20K ResNet18-dilated8 + PPM, Cityscapes; modules/multimodal/modalities/
image.py:721-1398).  A checkpoint's ``state_dict`` is read with
``torch.load(..., weights_only=True)`` (plain tensors only) and its keys are
mapped onto the state of :class:`deepviewagg_tpu_torch.modules.
image_encoders.ResNet18` built with ``norm='batch'``:

  conv1 / bn1                  -> Conv2dWS_0 / _Norm_0.BatchNorm_0
  conv1..3 / bn1..3            -> Conv2dWS_0..2 / _Norm_0..2 (the MIT-semseg
                                  deep stem, detected by ``conv3.weight``)
  layer{i}.{j}.conv{k} / bn{k} -> _BasicBlock2d_{2(i-1)+j}.Conv2dWS_{k-1} /
                                  _Norm_{k-1}
  layer{i}.{j}.downsample.0/1  -> the block's Conv2dWS_2 / _Norm_2
  ppm.{i}.1 / ppm.{i}.2        -> PPM's Conv2dWS_{i} / _Norm_{i}
  conv_last.0 / conv_last.1    -> PPM's Conv2dWS_4 / _Norm_4

BatchNorm ``weight`` / ``bias`` / ``running_mean`` / ``running_var`` keep
their names; ``num_batches_tracked`` is skipped.  A conv kernel ``[O, I, kh,
kw]`` becomes ``[O, I, kw, kh]``: the towers run ``[I, C, W, H]`` maps, W
before H (the JAX converter's OIHW -> WHIO).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

__all__ = ["convert_resnet18", "convert_ppm_head", "load_torch_state_dict",
           "merge_tower_params", "strip_prefix"]


def strip_prefix(sd: Dict[str, torch.Tensor],
                 prefix: str) -> Dict[str, torch.Tensor]:
    """Drop a wrapper prefix (``module.`` from DataParallel saves,
    ``encoder.`` / ``backbone.`` from segmentation checkpoints) so the
    converters below see bare keys."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors on the CPU (a ``{"state_dict": ...}`` wrapper
    is opened, ``module.`` dropped from every key, ``num_batches_tracked``
    skipped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v.detach().cpu()
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _conv(w: torch.Tensor) -> torch.Tensor:
    # [O, I, kh, kw] -> [O, I, kw, kh]: the maps are [I, C, W, H]
    return w.transpose(2, 3).contiguous()


def _conv_bn(out: dict, sd: dict, conv: str, bn: str, dst: str,
             norm: str) -> None:
    out[f"{dst}.weight"] = _conv(sd[f"{conv}.weight"])
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{norm}.BatchNorm_0.{name}"] = sd[f"{bn}.{name}"]


def convert_resnet18(sd: Dict[str, torch.Tensor],
                     out_level: int = 4) -> Dict[str, torch.Tensor]:
    """-> the state (parameters and running statistics, by key) of
    ``ResNet18(norm='batch', out_level=out_level)``.  Tolerates truncated
    checkpoints (missing blocks are skipped); the stem is the deep one when
    ``conv3.weight`` is present (build the tower with ``deep_stem=True``),
    else torchvision's 7x7 ``conv1``."""
    out: Dict[str, torch.Tensor] = {}
    n_stem = 3 if "conv3.weight" in sd else 1
    for i in range(n_stem):
        _conv_bn(out, sd, f"conv{i + 1}", f"bn{i + 1}", f"Conv2dWS_{i}",
                 f"_Norm_{i}")
    block_idx = 0
    for layer in range(1, out_level + 1):
        for j in range(2):
            tp = f"layer{layer}.{j}"
            if f"{tp}.conv1.weight" not in sd:
                continue
            bp = f"_BasicBlock2d_{block_idx}"
            block_idx += 1
            for k in (1, 2):
                _conv_bn(out, sd, f"{tp}.conv{k}", f"{tp}.bn{k}",
                         f"{bp}.Conv2dWS_{k - 1}", f"{bp}._Norm_{k - 1}")
            if f"{tp}.downsample.0.weight" in sd:
                _conv_bn(out, sd, f"{tp}.downsample.0", f"{tp}.downsample.1",
                         f"{bp}.Conv2dWS_2", f"{bp}._Norm_2")
    return out


def convert_ppm_head(sd: Dict[str, torch.Tensor],
                     bins: int = 4) -> Dict[str, torch.Tensor]:
    """-> the state of ``PPM(norm='batch')`` from an MIT-semseg ``PPMDeepsup``
    decoder state dict (the reference keeps the ``ppm.{i}`` scale convs and
    ``conv_last``'s fused 3x3 conv + BN, modalities/image.py:659-720; keys
    ``ppm.{i}.1/2`` are the 1x1 conv + BN inside each Sequential,
    ``conv_last.0/1`` the 3x3 conv + BN)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(bins):
        if f"ppm.{i}.1.weight" in sd:
            _conv_bn(out, sd, f"ppm.{i}.1", f"ppm.{i}.2", f"Conv2dWS_{i}",
                     f"_Norm_{i}")
    if "conv_last.0.weight" in sd:
        _conv_bn(out, sd, "conv_last.0", "conv_last.1", f"Conv2dWS_{bins}",
                 f"_Norm_{bins}")
    return out


@torch.no_grad()
def merge_tower_params(module: nn.Module,
                       converted: Dict[str, torch.Tensor]) -> int:
    """Overlay converted tensors onto ``module``'s parameters and buffers,
    shape-checked entry by entry (``ValueError`` on a mismatch, ``KeyError``
    for an entry the module lacks); returns how many parameters were
    written."""
    params = dict(module.named_parameters())
    targets = {**params, **dict(module.named_buffers())}
    for key, value in converted.items():
        if key not in targets:
            raise KeyError(f"the tower has no {key!r}")
        dst = targets[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(dst.shape)} "
                             f"vs {tuple(value.shape)}")
        dst.copy_(value.to(dst.dtype))
    return sum(key in params for key in converted)
