"""Pretrained 2D towers: load a torch ResNet-18 checkpoint into every image
branch of a built model.

The port of ``deepviewagg_tpu/utils/pretrained.py``.  The reference's
published recipes (``...-ade20k-interpolate``, the Cityscapes PointPyramid)
get their accuracy from pretrained towers (modules/multimodal/modalities/
image.py:721-1398).  ``cli.train`` calls :func:`apply_tower_weights` after
the model is built when ``model.tower_weights`` is set;
:func:`~deepviewagg_tpu_torch.config.zoo.resolve_spec_from_cfg` has then
switched the branches to BatchNorm towers (``tower_norm='batch'``: the
checkpoints carry BatchNorm statistics) and to the checkpoint's stem.

The branches' module names are the models' own: ``branch_l<level>`` and
``branch_l<level>_<k>`` (the k-th further branch at a level, e.g. the five
PointPyramid towers) in ``MultimodalSeg``, ``branch`` and ``branch_<k>`` in
the no3d and late-fusion families.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from torch import nn

from .torch_convert import (convert_ppm_head, convert_resnet18,
                            load_torch_state_dict, merge_tower_params,
                            strip_prefix)

__all__ = ["apply_tower_weights", "branch_names", "freeze_paths_for_spec",
           "tower_leaf_count", "tower_param_path"]

# towers that wrap the trunk in a submodule (ResNet18PPM / ResNet18Pyramid
# hold their ResNet18 as ResNet18_0)
_WRAPPED = {"resnet18_ppm": ("ResNet18_0",),
            "resnet18_pyramid": ("ResNet18_0",),
            "resnet18_pyramid_raw": ("ResNet18_0",)}


def branch_names(spec) -> Iterator[Tuple[str, object]]:
    """``(module name, BranchSpec)`` of every image branch of the spec's
    model."""
    if spec.family != "unet":
        for k, (_, b) in enumerate(spec.branches):
            yield ("branch" if k == 0 else f"branch_{k}"), b
        return
    k_at: dict = {}
    for level, b in spec.branches:
        k = k_at.get(level, 0)
        k_at[level] = k + 1
        yield (f"branch_l{level}" if k == 0 else f"branch_l{level}_{k}"), b


def tower_param_path(name: str, bspec) -> Tuple[str, ...]:
    """Path of a branch's trunk in the model (the JAX package's variable
    path of the same trunk)."""
    return (name, "tower") + _WRAPPED.get(bspec.tower, ())


def freeze_paths_for_spec(spec) -> Tuple[Tuple[str, str], ...]:
    """Parameter-name prefixes of the frozen towers, kept out of the
    optimizer (their running statistics are buffers, never in it)."""
    return tuple((name, "tower") for name, b in branch_names(spec)
                 if b.frozen)


def _out_level(tower: str) -> int:
    return int(tower[-1]) if tower.startswith("resnet18_l") else 4


def _decoder_state(sd: dict) -> dict:
    """The PPM decoder's keys: MIT ships ``encoder_`` / ``decoder_``
    checkpoints; a merged dict or a decoder-only one both work."""
    for prefix in ("decoder.", "ppm_deepsup.", "ppm."):
        if any(k.startswith(prefix) for k in sd):
            sd = strip_prefix(sd, prefix)
            if prefix == "ppm.":       # the converter reads ppm.* keys
                sd = {k if k.startswith("conv_last") else f"ppm.{k}": v
                      for k, v in sd.items()}
            break
    return sd


def apply_tower_weights(model: nn.Module, spec, path: str) -> Dict[str, int]:
    """Overlay a torch ResNet18 checkpoint onto every image branch of
    ``model`` (built from ``spec``), in place; the PPM tower's head comes
    from the decoder-prefixed keys when the checkpoint holds them.  Returns
    the parameters written per trunk and head path (``'/'``-joined).
    Raises ``ValueError`` when no branch is a BatchNorm tower, when the
    checkpoint's stem (deep: ``conv3.weight`` present) is not a branch's
    ``tower_deep_stem``, or on a shape mismatch."""
    sd = load_torch_state_dict(path)
    for prefix in ("module.", "encoder.", "backbone."):
        sd = strip_prefix(sd, prefix)
    if not any(b.tower_norm == "batch" for _, b in spec.branches):
        raise ValueError(
            "pretrained tower weights need tower_norm='batch' on the branch "
            "spec (torch checkpoints carry BatchNorm statistics)")
    deep = "conv3.weight" in sd
    loaded: Dict[str, int] = {}
    for name, b in branch_names(spec):
        if deep != b.tower_deep_stem:
            raise ValueError(
                "checkpoint stem does not match the tower: checkpoint "
                f"deep_stem={deep} vs branch tower_deep_stem="
                f"{b.tower_deep_stem} (resolve_spec_from_cfg sets it from "
                "the checkpoint)")
        trunk = tower_param_path(name, b)
        loaded["/".join(trunk)] = merge_tower_params(
            model.get_submodule(".".join(trunk)),
            convert_resnet18(sd, out_level=_out_level(b.tower)))
        if b.tower == "resnet18_ppm":
            dsd = _decoder_state(sd)
            if any(k.startswith("ppm.") for k in dsd):
                head = (name, "tower", "PPM_0")
                loaded["/".join(head)] = merge_tower_params(
                    model.get_submodule(".".join(head)),
                    convert_ppm_head(dsd))
    return loaded


def tower_leaf_count(model: nn.Module, spec) -> Dict[str, int]:
    """Parameters per trunk (the JAX package's leaf count of the same
    subtree)."""
    out = {}
    for name, b in branch_names(spec):
        trunk = tower_param_path(name, b)
        out["/".join(trunk)] = sum(
            1 for _ in model.get_submodule(".".join(trunk)).parameters())
    return out
