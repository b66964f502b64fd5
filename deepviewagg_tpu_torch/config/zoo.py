"""The model zoo: the reference's named-config space as a generator.

The port of ``deepviewagg_tpu/config/zoo.py``: the same names, grammar and
specs.  Name resolution is pure data, so every name resolves and every
zoo name builds; ``ref:<file>/<entry>`` names ingest a published reference
YAML entry (:mod:`.reference_ingest`).  Every field of every spec is the
JAX one; like the JAX
``_to_spec``, a zoo entry's ``head_dropout`` override is dropped (build a
model with ``dataclasses.replace(spec, head_dropout=p)`` for MC dropout).
The JAX docstring follows.

conf/models/segmentation/multimodal/sparseconv3d.yaml holds ~109 named
entries crossing: fusion depth (early L0..L5 / pyramid / late), fusion mode
(residual/concat/both/modality), pooling (max/mean/heuristic/group-N/qkv),
2D towers (scratch ResNet-N + pretrained truncations/pyramids/PPM), and
interpolate/checkpointing variants (SURVEY.md §A.11).  The reference treats
this as a config-space contract, not 109 hand-written models — so here the
zoo IS the cross-product generator, plus the handful of published names
mapped explicitly.
"""

from __future__ import annotations

import re
from typing import Optional

from ..models.segmentation import BranchSpec, ModelSpec
from ..modules.scratch2d import tower_cfg_out_channels

__all__ = ["MODEL_ZOO", "get_model_spec", "parse_model_name"]

# published/benchmark names -> canonical definitions (README.md:104-108)
_NAMED = {
    # S3DIS / ScanNet flagship. Faithful to the published YAML
    # (multimodal/sparseconv3d.yaml:6622-6672): the 512-d Layer4 tower
    # features are attention-pooled with num_groups=4 (use_mod=False,
    # DeepSetFeat) and CONCATENATED with the raw point features before the
    # stem — not residually added.
    "Res16UNet34-L4-early": dict(
        backbone="Res16UNet34",
        branches=[dict(level=0, tower="resnet18_l4", out_channels=512,
                       view_pool="group", num_groups=4,
                       fusion_mode="concat", interpolate=True)],
    ),
    "Res16UNet34-L4-early-ade20k-interpolate": dict(
        backbone="Res16UNet34",
        # the ADE20K (MIT-semseg) encoder is a deep-3-conv-stem ResNet18
        # (yaml:8072 ADE20KResNet18TruncatedLayer4) — the architecture
        # carries the deep stem even before weights load
        branches=[dict(level=0, tower="resnet18_l4", out_channels=512,
                       view_pool="group", num_groups=4,
                       fusion_mode="concat", interpolate=True,
                       tower_deep_stem=True)],
    ),
    # KITTI-360 flagship, FAITHFUL (yaml:7275-7352): FIVE branches at level
    # 0 — Cityscapes (deep-stem) ResNet18 truncations Layer0..Layer4, each
    # with its own group-4 attention pool to 32/32/64/128/256, all
    # concatenated pre-stem (branching_index [0..4], n_early_conv=5) = +512.
    "Res16UNet34-PointPyramid-early-cityscapes-interpolate": dict(
        backbone="Res16UNet34",
        branches=[
            dict(level=0, tower=f"resnet18_l{i}", out_channels=o,
                 view_pool="group", num_groups=4, fusion_mode="concat",
                 interpolate=True, tower_deep_stem=True)
            for i, o in enumerate((32, 32, 64, 128, 256))
        ],
    ),
    # engineering variant under an honest distinct name: ONE shared pyramid
    # tower (modules/image_encoders.py ResNet18Pyramid) serving every scale
    # from a single gather, one group-4 pool to the same +512 — cheaper per
    # step than the faithful five-tower entry, not the published arch
    "Res16UNet34-SharedPyramid-early-interpolate": dict(
        backbone="Res16UNet34",
        branches=[dict(level=0, tower="resnet18_pyramid", out_channels=512,
                       view_pool="group", num_groups=4,
                       fusion_mode="concat", interpolate=True)],
    ),
    "Res16UNet34": dict(backbone="Res16UNet34", branches=[]),
    "Res16UNet18": dict(backbone="Res16UNet18", branches=[]),
    "Res16UNet14": dict(backbone="Res16UNet14", branches=[]),
    # no3d family (2D-only towers pooled to points,
    # conf/models/segmentation/multimodal/no3d.yaml)
    "No3D-ADE20K-group8": dict(
        family="no3d",
        branches=[dict(level=0, tower="resnet18_ppm", view_pool="group",
                       num_groups=8, interpolate=True)],
    ),
    # the published light no3d model (no3d.yaml:5: 6.1M params, scratch 2D
    # UNet tower whose last_conv emits N_CLS per-pixel logits, atomic max +
    # view MEAN pooling, NO head — class no3d.No3DLogitFusion)
    "Res16UNet21-15_light": dict(
        family="no3d", no3d_head=False,
        branches=[dict(level=0, tower="scratch_unet", tower_cfg="light",
                       atomic_reduce="max", view_pool="mean",
                       # the published entry does NOT set interpolate; the
                       # reference default is exact integer-pixel gather
                       # (unet.py:538)
                       interpolate=False)],
    ),
    "No3D-L4-max": dict(
        family="no3d",
        branches=[dict(level=0, tower="resnet18_l4", view_pool="max",
                       interpolate=True)],
    ),
    # late-fusion variants (models/segmentation/multimodal/sparseconv3d.py)
    "Res16UNet34-LateFeatureFusion": dict(
        backbone="Res16UNet34", family="late_feature",
        branches=[dict(level=0, tower="resnet18_l4", view_pool="group",
                       num_groups=8, interpolate=True)],
    ),
    "Res16UNet34-LateLogitFusion": dict(
        backbone="Res16UNet34", family="late_logit",
        branches=[dict(level=0, tower="resnet18_l4", view_pool="group",
                       num_groups=8, interpolate=True)],
    ),
}

# Point Transformer V3 (Wu et al., CVPR 2024): Pointcept's S3DIS
# semseg-pt-v3m1-0-base, 3D-only over the "ptv3" collate route; the
# backbone names a preset of nn/ptv3.py (PTv3Test: the narrow test net)
# the recipe's parameter groups ride with the entry: the parameters whose
# names hold "block" train at a tenth of the learning rate
_NAMED["PTv3-m1-base"] = dict(family="ptv3", backbone="PTv3-m1-base",
                              stem_kernel=5, lr_keywords={"block": 0.1})

_POOLS = {"max": ("max", 1), "mean": ("mean", 1), "heuristic": ("heuristic", 1),
          "qkv": ("qkv", 1)}


def _drop_p(token) -> float:
    if not token:
        return 0.0
    p = int(token) / 100.0
    if not 0.0 <= p <= 0.95:
        raise ValueError(f"modality dropout {p} outside [0, 0.95]")
    return p


def parse_model_name(name: str) -> Optional[dict]:
    """Grammar: ``<Backbone>-L<k>-<depth>[-<pool>][-<tower>][-interpolate]``

    e.g. ``Res16UNet34-L2-intermediate-group8-imagenet-interpolate``:
    2D tower truncated at layer 2, branch at encoder level matching depth
    ('early'=0, 'intermediate<k>'=k, 'late' handled by LateFusion models),
    group attention with 8 groups.
    """
    m = re.match(
        r"^(?P<bb>Res16UNet\d+[A-C]?)"
        r"(?:-L(?P<tl>\d))?"
        r"-(?P<depth>early|intermediate\d?|late)"
        r"(?:-(?P<pool>max|mean|heuristic|qkv|group\d*))?"
        r"(?:-(?P<tower>ade20k|imagenet|cityscapes|scratch|ppm))?"
        r"(?P<nogating>-nogating)?"
        r"(?:-(?P<hard>hard)?drop(?P<drop>\d+))?"
        r"(?P<interp>-interpolate)?$",
        name,
    )
    if not m:
        return None
    d = m.groupdict()
    tower_level = int(d["tl"]) if d["tl"] else 4
    depth = d["depth"]
    level = 0 if depth in ("early", "late") else (
        int(depth[len("intermediate"):]) if len(depth) > len("intermediate") else 1
    )
    pool, groups = "group", 8
    if d["pool"]:
        if d["pool"].startswith("group"):
            groups = int(d["pool"][5:] or 1)
        else:
            pool, groups = _POOLS[d["pool"]]
    # the pretrained-source token (ade20k/cityscapes/imagenet) selects the
    # WEIGHTS (model.tower_weights), not the architecture: truncations stay
    # resnet18_l<k>; only the explicit 'ppm' token picks the PPM-head tower
    tower = ("resnet18_ppm" if d["tower"] == "ppm"
             else f"resnet18_l{tower_level}")
    # early (pre-stem) entries in the reference zoo all CONCAT with the raw
    # features; residual fusion appears at intermediate levels where the 2D
    # stage widths match the 3D stream (yaml:40-67)
    fusion = "concat" if level == 0 else "residual"
    return dict(
        backbone=d["bb"],
        branches=[dict(level=level, tower=tower, view_pool=pool,
                       num_groups=groups, fusion_mode=fusion,
                       # -nogating / -dropN / -harddropN variants
                       # (yaml:6690, 6348; ref modules.py:272 distinguishes
                       # soft nn.Dropout from hard ModalityDropout)
                       gated=not d["nogating"],
                       drop_modality=_drop_p(d["drop"]),
                       drop_hard=bool(d["hard"]) or not d["drop"],
                       interpolate=bool(d["interp"]))],
    )


def _light_tower_cfg(num_classes: int):
    """TowerCfg of the published light no3d UNet (no3d.yaml:14-51:
    in_feat=32, 5 ResNetDown stages [stride 1,2,2,2,2], 5 ResNetUp stages,
    1x1 last_conv to N_CLS) — built with the parity-pinned scratch stack
    (modules/scratch2d.py)."""
    f = 32
    down = ((4, f, 3, 1, 1, 0), (f, f, 2, 2, 0, 2), (f, 2 * f, 2, 2, 0, 2),
            (2 * f, 4 * f, 2, 2, 0, 2), (4 * f, 8 * f, 2, 2, 0, 2))
    up = ((8 * f, 4 * f, 4 * f, 2, 2, 0, 1), (4 * f, 2 * f, 3 * f, 2, 2, 0, 1),
          (3 * f, f, 2 * f, 2, 2, 0, 1), (2 * f, f, f, 2, 2, 0, 1),
          (f, 0, f, 3, 1, 1, 1))
    return (down, up, num_classes)


def _to_spec(entry: dict, num_classes: int, in_channels: int) -> ModelSpec:
    def _branch_tower_cfg(b):
        tcfg = b.get("tower_cfg")
        return _light_tower_cfg(num_classes) if tcfg == "light" else tcfg

    branches = tuple(
        (b["level"], BranchSpec(
            tower=b.get("tower", "resnet18_l4"),
            tower_cfg=(tcfg := _branch_tower_cfg(b)),
            tower_ws=b.get("tower_ws", True),
            out_channels=b.get(
                "out_channels",
                tower_cfg_out_channels(tcfg) if tcfg else 64),
            atomic_reduce=b.get("atomic_reduce", "max"),
            view_pool=b.get("view_pool", "group"),
            num_groups=b.get("num_groups", 1),
            use_mod=b.get("use_mod", False),
            gated=b.get("gated", True),
            interpolate=b.get("interpolate", True),
            drop_modality=b.get("drop_modality", 0.0),
            drop_3d=b.get("drop_3d", 0.0),
            drop_hard=b.get("drop_hard", True),
            fusion_mode=b.get("fusion_mode", "residual"),
            # entry-level fallback so cfg.model.overrides can pin the stem
            # family for every branch (persisted by train.py, used when the
            # tower checkpoint is absent at eval/predict time)
            tower_deep_stem=b.get("tower_deep_stem",
                                  entry.get("tower_deep_stem", False)),
            remat_tower=b.get("remat_tower", "convs"),
            tower_norm=b.get("tower_norm", "group"),
            frozen=b.get("frozen", False),
            tower_bf16=b.get("tower_bf16",
                             entry.get("tower_bf16", True)),
        ))
        for b in entry.get("branches", [])
    )
    return ModelSpec(
        num_classes=num_classes,
        in_channels=in_channels,
        backbone=entry.get("backbone", "Res16UNet34"),
        branches=branches,
        family=entry.get("family", "unet"),
        stem_kernel=entry.get("stem_kernel", 3),
        no3d_head=entry.get("no3d_head", True),
    )


MODEL_ZOO = dict(_NAMED)


def get_model_spec(name: str, num_classes: int, in_channels: int = 4,
                   overrides: Optional[dict] = None) -> ModelSpec:
    """Resolve a model name (published table or grammar) to a ModelSpec —
    the role of ``instantiate_model`` + ``resolve_model``
    (models/model_factory.py:8-46).

    ``ref:<file>/<entry>`` ingests a published reference YAML entry
    (:mod:`.reference_ingest`) from ``$DVA_REFERENCE_CONF`` (the
    reference's ``conf/models/segmentation``): ``multimodal/<file>.yaml``
    first, then ``<file>.yaml``, falling through only when the entry is
    absent; its ``overrides`` apply by ``ModelSpec`` field name.  Other
    names' ``overrides`` update the zoo entry before it becomes a spec."""
    if name.startswith("ref:"):
        return _ref_spec(name, num_classes, in_channels, overrides)
    entry = MODEL_ZOO.get(name) or parse_model_name(name)
    if entry is None:
        # any Res16UNet preset name is a valid bare 3D-only backbone
        # (Res16UNet50/101, letter variants, the SE family, the test net)
        from ..nn.res16unet import RES16_PRESETS

        if name in RES16_PRESETS:
            entry = {"backbone": name}
    if entry is None:
        raise KeyError(
            f"unknown model '{name}'; known: {sorted(MODEL_ZOO)} or grammar "
            "'<Backbone>-L<k>-<early|intermediateN>[-<pool>][-<tower>][-interpolate]'"
        )
    entry = dict(entry)
    if overrides:
        entry.update(overrides)
    return _to_spec(entry, num_classes, in_channels)


def _ref_spec(name: str, num_classes: int, in_channels: int,
              overrides: Optional[dict]) -> ModelSpec:
    """The spec of a ``ref:<file>/<entry>`` name (see get_model_spec)."""
    import dataclasses as _dc
    import os

    from .reference_ingest import load_model_spec, load_yaml_doc

    fname, entry_name = name[4:].split("/", 1)
    base = os.environ.get("DVA_REFERENCE_CONF",
                          "/root/reference/conf/models/segmentation")
    candidates = [p for p in (f"{base}/multimodal/{fname}.yaml",
                              f"{base}/{fname}.yaml") if os.path.exists(p)]
    spec = None
    for path in candidates:
        # only fall through when the ENTRY is absent: genuine ingest errors
        # (unknown DSL keys etc.) surface, not as a name typo
        if entry_name in (load_yaml_doc(path) or {}):
            spec = load_model_spec(path, entry_name, num_classes, in_channels)
            break
    if spec is None:
        raise KeyError(f"entry '{entry_name}' not found for '{name}' "
                       f"(searched {candidates})")
    if overrides:
        known = {f.name for f in _dc.fields(spec)}
        spec = _dc.replace(
            spec, **{k: v for k, v in overrides.items() if k in known})
    return spec


def recipe_lr_keywords(name: str, overrides: Optional[dict] = None):
    """The LR multipliers by parameter-name keyword that a zoo entry's
    recipe sets (``lr_keywords``; an override of that key wins), or
    None."""
    entry = dict(MODEL_ZOO.get(name) or {})
    entry.update(overrides or {})
    return entry.get("lr_keywords")


def resolve_spec_from_cfg(model_cfg, num_classes: int) -> ModelSpec:
    """ModelCfg -> ModelSpec, applying the pretrained-tower implications:
    ``tower_weights`` switches the branches to BatchNorm towers (the torch
    checkpoints carry BatchNorm statistics) with the checkpoint's stem, and
    ``tower_frozen`` marks them frozen.  Shared by the CLIs so a restored
    checkpoint always rebuilds the exact trained architecture."""
    import dataclasses as _dc

    spec = get_model_spec(model_cfg.name, num_classes, model_cfg.in_channels,
                          model_cfg.overrides)
    tw = getattr(model_cfg, "tower_weights", None)
    tf = getattr(model_cfg, "tower_frozen", False)
    # a pretrained-source token names the WEIGHTS, which only load through
    # model.tower_weights — a name promising ade20k that silently trains a
    # scratch tower is a trap
    if not tw and re.search(r"-(ade20k|cityscapes|imagenet)(-|$)",
                            model_cfg.name):
        import warnings

        warnings.warn(
            f"model '{model_cfg.name}' names pretrained weights but "
            "model.tower_weights is unset — the tower will train FROM "
            "SCRATCH; pass tower_weights=<converted .pth> to load them"
        )
    # MIT-semseg encoders (ADE20K, Cityscapes) have the deep 3-conv stem:
    # sniff the checkpoint here so every CLI rebuilds the trained stem.  An
    # overrides['tower_deep_stem'] pin (cli.train persists it) wins and
    # covers a checkpoint file that has gone; an unreadable file leaves the
    # spec's own value.
    if tw and "tower_deep_stem" not in (model_cfg.overrides or {}):
        try:
            from ..utils.torch_convert import (load_torch_state_dict,
                                               strip_prefix)

            sd = load_torch_state_dict(tw)
            for prefix in ("module.", "encoder.", "backbone."):
                sd = strip_prefix(sd, prefix)
            if "conv3.weight" in sd:
                spec = _dc.replace(spec, branches=tuple(
                    (lvl, _dc.replace(b, tower_deep_stem=True))
                    for lvl, b in spec.branches))
        except (OSError, ValueError, RuntimeError):
            pass
    if tw or tf:
        spec = _dc.replace(spec, branches=tuple(
            (lvl, _dc.replace(b, tower_norm="batch" if tw else b.tower_norm,
                              frozen=tf))
            for lvl, b in spec.branches))
    return spec
