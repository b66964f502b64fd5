"""Ingest the reference's published Hydra YAMLs into the port's specs.

The port of ``deepviewagg_tpu/config/reference_ingest.py``, with its own
copies of every table and rule; the files are read by :mod:`.yaml_subset`
(the card's machine has no PyYAML), which reads the DSL's forms as PyYAML's
``safe_load`` does and refuses what it does not read.  As in the JAX module,
``${...}`` interpolations stay strings until :func:`_interp_data` resolves
them (no OmegaConf).  The JAX docstring follows.

The reference's model zoo is an architecture DSL (``down_conv`` lists with
``define_constants`` arithmetic, per-modality subtrees, ``branching_index``
— models/base_architectures/unet.py:402-552, resolved by
utils/model_building_utils/model_definition_resolver.py).  This module reads
those files directly:

  * :func:`load_model_spec` — one named entry of
    ``conf/models/segmentation/multimodal/{sparseconv3d,no3d}.yaml`` ->
    :class:`ModelSpec`;
  * :func:`load_data_cfg` — a multimodal data YAML
    (``s3disfused-sparse.yaml``...) -> the ``data`` section fields of
    :class:`RunConfig`.

This makes the "config-space contract" executable: the published recipes
resolve to the same specs the zoo grammar produces.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from ..models.segmentation import BranchSpec, ModelSpec
from .yaml_subset import safe_load

__all__ = ["load_model_spec", "load_data_cfg", "resolve_constant",
           "load_yaml_doc", "load_model_entry"]


# reference 2D encoder class names -> (this repo's tower, deep_stem)
# (modules/multimodal/modalities/image.py:721-1398; MIT-semseg ADE20K and
# Cityscapes encoders use the deep 3-conv stem, torchvision ImageNet the
# plain 7x7 stem)
def _tower_of(module_name: str) -> Tuple[str, bool]:
    m = re.match(r"^(ADE20K|Cityscapes|)ResNet18"
                 r"(?:Truncated)?(?:Layer)?(\d)?(PPM|Pyramid)?$",
                 module_name)
    if not m:
        raise KeyError(f"unknown 2D encoder '{module_name}'")
    src, layer, kind = m.group(1), m.group(2), m.group(3)
    deep = src in ("ADE20K", "Cityscapes")
    if kind == "PPM":
        return "resnet18_ppm", deep
    if kind == "Pyramid":
        # the reference class returns the RAW resized tap concat — no
        # projection conv (modalities/image.py ADE20KResNet18Pyramid.forward)
        return "resnet18_pyramid_raw", deep
    return f"resnet18_l{layer or 4}", deep


_BACKBONES = {
    (1, 1, 1, 1): "Res16UNet14",
    (2, 2, 2, 2): "Res16UNet18",
    (2, 3, 4, 6): "Res16UNet34",
}

# tower key suffix -> output channels (image_encoders.OUT_CHANNELS order)
_TOWER_CHANNELS = {"l0": 64, "l1": 64, "l2": 128, "l3": 256, "l4": 512,
                   "ppm": 128, "pyramid": 128,
                   # raw tap concat: stem + layer1..4 (64/128-deep-stem
                   # + 64 + 128 + 256 + 512)
                   "raw": 1024}


def resolve_constant(val, constants: Dict, feat: Optional[int] = None):
    """Evaluate a ``define_constants`` expression — the role of
    ``model_definition_resolver.resolve_model`` (FEAT arithmetic,
    ``4*in_feat``-style strings)."""
    if isinstance(val, (int, float)):
        return val
    if isinstance(val, list):
        return [resolve_constant(v, constants, feat) for v in val]
    if not isinstance(val, str):
        return val
    env = dict(constants)
    if feat is not None:
        env.setdefault("FEAT", feat)
        env.setdefault("N_CLS", feat)
    # expressions are simple arithmetic over named constants
    if not re.fullmatch(r"[\w\s+\-*/().]+", val):
        return val
    try:
        return eval(val, {"__builtins__": {}}, env)  # noqa: S307
    except Exception:
        return val


def _as_list(v, n: int) -> List:
    return list(v) if isinstance(v, list) else [v] * n


# parsed-YAML memo: the published model files are ~3600 lines and parsing
# dominates load_model_spec (the port's pure-Python reader is slower than
# PyYAML); per-entry resolution reads one file for many entries
_DOC_CACHE: Dict[Tuple[str, float], Dict] = {}


def load_yaml_doc(path: str) -> Dict:
    key = (path, os.path.getmtime(path))
    if key not in _DOC_CACHE:
        _DOC_CACHE.clear()          # one live doc per path generation
        with open(path) as f:
            _DOC_CACHE[key] = safe_load(f.read())
    return _DOC_CACHE[key]


def load_model_entry(path: str, name: str) -> Dict:
    doc = load_yaml_doc(path)
    if name not in doc:
        raise KeyError(f"entry '{name}' not in {path}")
    return doc[name]


# view-pool module name -> this repo's pool key.  AttentiveBimodalCSRPool
# appears in 13 YAML entries but no such class exists in the live reference
# code (pooling.py only defines QKVBimodalCSRPool, whose docstring still
# carries the old Attentive name; the reference's getattr-based factory
# would resolve it to None) — we map it to its renamed successor.
_POOL_NAMES = {
    "GroupBimodalCSRPool": "group",
    "QKVBimodalCSRPool": "qkv",
    "AttentiveBimodalCSRPool": "qkv",
    "HeuristicBimodalCSRPool": "heuristic",
}


def _pool_kwargs(vp: Dict, pool: str) -> Dict:
    """``view_pooling`` subtree -> learned-pool BranchSpec kwargs.

    ``group_scaling`` defaults follow the class the YAML names:
    GroupBimodalCSRPool defaults True (ref pooling.py:209), QKV False
    (:373).  ``use_map_min/max/num`` and ``in_score`` keys are deliberately
    NOT read: upstream forwards them into set encoders that only accept
    ``use_min/max/num``, so ``**kwargs`` swallows them and class defaults
    win — faithful ingestion reproduces the executed behavior, not the
    YAML author's intent (see QKVViewPool docstring)."""
    return dict(
        set_encoder={"MinMaxDiffSetFeat": "minmaxdiff",
                     "MLPSetFeat": "mlp"}.get(
            vp.get("map_encoder", ""), "deepset"),
        pool_use_num=bool(vp.get("use_num", False)),
        pool_scaling=bool(vp.get("group_scaling", pool == "group")),
        gated=bool(vp.get("gating", True)),
        use_mod=bool(vp.get("use_mod", False)),
        use_mod_q=bool(vp.get("use_mod_q", False)),
        use_mod_k=bool(vp.get("use_mod_k", False)),
        qk_channels=int(vp.get("nc_qk", 8)),
        dim_scaling=bool(vp.get("dim_scaling", True)),
        pool_modes=tuple(str(vp.get("pool", "max")).split("_")),
        pool_fusion=str(vp.get("fusion", "concatenation")),
    )


def _n_stages(conv: Dict) -> int:
    nn_ = conv.get("down_conv_nn", conv.get("up_conv_nn"))
    return len(nn_) if isinstance(nn_, list) else 1


def _stage_strides(conv: Dict, constants: Optional[Dict] = None) -> List[int]:
    n = _n_stages(conv)
    sv = conv.get("stride", [1] + [2] * (n - 1))
    out = []
    for s in _as_list(sv, n):
        r = resolve_constant(s, constants or {})
        if not isinstance(r, (int, float)):
            # fail loudly: a silently-substituted stride would build a
            # structurally different backbone
            raise ValueError(f"unresolvable stride expression {s!r}")
        out.append(int(r))
    return out


def _extract_backbone_plan(down: Dict, up: Dict, constants: Dict,
                           in_channels: int):
    """Generic down_conv/up_conv DSL -> (layers, planes) for Res16UNet.

    Stages group into UNet levels at each stride-2 boundary (the 21-15
    family writes each level as a stride-2 conv stage followed by a
    stride-1 residual stage); stride-1 stages before the first downsample
    are the stem.  Decoder levels likewise; trailing stride-1 up stages
    fold their blocks into the last level.
    """
    N = [int(n) for n in _as_list(down["N"], _n_stages(down))]
    strides = _stage_strides(down, constants)
    outs = [resolve_constant(nn_[1], constants, in_channels)
            for nn_ in down["down_conv_nn"]]
    enc_blocks: List[int] = []
    enc_planes: List[int] = []
    for n, s, o in zip(N, strides, outs):
        if s == 2:
            enc_blocks.append(n)
            enc_planes.append(int(o))
        elif enc_blocks:
            enc_blocks[-1] += n
            enc_planes[-1] = int(o)
    if not up:
        return tuple(enc_blocks), tuple(enc_planes)
    N_up = [int(n) for n in _as_list(up["N"], _n_stages(up))]
    s_up = _stage_strides(up, constants)
    outs_up = [resolve_constant(nn_[-1], constants, in_channels)
               for nn_ in up["up_conv_nn"]]
    dec_blocks: List[int] = []
    dec_planes: List[int] = []
    for n, s, o in zip(N_up, s_up, outs_up):
        if s == 2 or not dec_blocks:
            dec_blocks.append(n)
            dec_planes.append(int(o))
        else:
            dec_blocks[-1] += n
            dec_planes[-1] = int(o)
    return (tuple(enc_blocks + dec_blocks),
            tuple(enc_planes + dec_planes))


def load_model_spec(path: str, name: str, num_classes: int,
                    in_channels: int = 4) -> ModelSpec:
    """One published model entry -> ModelSpec.

    Covers ALL multimodal sparseconv3d families — early/pyramid truncation
    branches and the Res16Image shared-trunk families (one progressive 2D
    encoder tapped at successive 3D levels), over named Res16UNet presets
    or inline custom backbone plans — plus the no3d families.
    """
    entry = load_model_entry(path, name)
    cls = entry.get("class", "")
    if cls.startswith("no3d."):
        return _no3d_spec(entry, num_classes, in_channels)
    if cls.startswith("minkowski."):
        # MinkowskiEngine baseline entries carry only a class name
        # (minkowski_baseline.yaml); map MinkUNetXX[Y] onto the matching
        # Res16UNet preset (same published plans, nn/res16unet.py table)
        from ..nn.res16unet import RES16_PRESETS

        mn = entry.get("model_name", name)
        preset = mn if mn.startswith("Res16UNet") else "Res16UNet" + mn[8:]
        if preset not in RES16_PRESETS:
            raise KeyError(f"no preset for {entry.get('model_name', name)}")
        return ModelSpec(num_classes=num_classes, in_channels=in_channels,
                         backbone=preset, stem_kernel=5)
    family = ("late_feature" if "LateFeatureFusion" in cls else
              "late_logit" if "LateLogitFusion" in cls else "unet")
    if "backbone_3d" in entry:
        return _late_spec(entry, num_classes, in_channels, family)
    bb = entry.get("backbone", entry)
    constants = dict(bb.get("define_constants", {}))
    down = bb["down_conv"]
    up = bb.get("up_conv", {})

    # infer the Res16UNet preset from the residual-block counts; fall back
    # to an inline custom plan for out-of-table stage layouts (21-15 family)
    enc_n = tuple(int(x) for x in down.get("N", [])[1:])
    backbone = _BACKBONES.get(enc_n)
    layers = planes = None
    if backbone is None:
        layers, planes = _extract_backbone_plan(down, up, constants,
                                                in_channels)
        backbone = "Res16UNet34"   # display name; plan overrides it
    stem_kernel = int(_as_list(down.get("kernel_size", [3]), 1)[0])
    strides3d = _stage_strides(down, constants)
    n_early = int(down.get("n_early_conv", 1))
    # conv3d_before/after_fusion interleave Identity 3D modules into the
    # padded module list (unet.py:459-470); 'before and not after' pairs
    # each raw module with a trailing Identity (fusion after the module),
    # 'after and not before' with a leading one (fusion before it)
    before = bool(down.get("conv3d_before_fusion", True))
    after = bool(down.get("conv3d_after_fusion", True))

    def level_of(bidx: int) -> int:
        # The reference PAIRS the (Identity-padded) 3D module list into
        # multimodal blocks — n_early_conv*2 Identities prepended, fusion
        # between block_1 and block_2 of block `bidx` (unet.py:441-510).
        # The 3D level at that fusion point is the number of stride-2 raw
        # modules that have already run, i.e. those whose padded index is
        # <= 2*bidx.
        bidx = int(bidx)
        if before and not after:
            # raw module j at padded index 2*(n_early + j): module j ran
            # iff 2*(n_early + j) <= 2*bidx
            n_run = max(0, bidx - n_early + 1)
        elif after and not before:
            # raw module j at padded index 2*(n_early + j) + 1: ran iff
            # 2*(n_early + j) + 1 <= 2*bidx
            n_run = max(0, bidx - n_early)
        else:
            # unpadded: raw module j at padded index 2*n_early + j: ran
            # iff 2*n_early + j <= 2*bidx
            n_run = max(0, 2 * bidx + 1 - 2 * n_early)
        return sum(1 for s in strides3d[:n_run] if s == 2)

    img = down.get("image")
    branches: List[Tuple[int, BranchSpec]] = []
    shared_tower = None
    if img is not None:
        idc = img["down_conv"]
        mod = idc["module_name"]
        bidx_raw = img.get("branching_index", 0)
        bidx = bidx_raw if isinstance(bidx_raw, list) else [bidx_raw]
        if mod == "ResNetDown" or (isinstance(mod, str) and len(bidx) > 1):
            # shared progressive trunk (Res16Image families): stage-i tap
            # feeds branching position i; a single-branch ResNetDown (the
            # ResImage3 'light' encoders) taps the trunk's final stage
            ns = _n_stages(idc)
            widths = [int(resolve_constant(p[1], constants, in_channels))
                      for p in idc["down_conv_nn"]]
            if any(w < 0 for w in widths):
                # [-1, -1] passthrough encoder: raw-pixel gather/pool
                towers = ["ModalityIdentity"] * len(bidx)
            else:
                blocks = [int(n) for n in _as_list(idc.get("N", 0), ns)]
                s2d = _stage_strides(idc, constants)
                shared_tower = (tuple(widths), tuple(blocks), tuple(s2d))
                towers = ([f"shared:{i}" for i in range(len(bidx))]
                          if len(bidx) > 1 else [f"shared:{ns - 1}"])
        else:
            towers = _as_list(mod, len(bidx))
            # In a module LIST, a ModalityIdentity AFTER a real tower means
            # "the image feature state is unchanged" (the reference threads
            # x_mod through the module sequence, modules.py:318-335): the
            # tower runs ONCE and its maps are re-gathered/pooled at every
            # later fusion level (XYZ-RGB-L4-all, sparseconv3d.yaml:3583).
            # Only an all-Identity list means raw-pixel gather/pool.
            if any(t != "ModalityIdentity" for t in towers):
                towers = [
                    ("reuse" if t == "ModalityIdentity"
                     and any(u != "ModalityIdentity" for u in towers[:j])
                     else t)
                    for j, t in enumerate(towers)
                ]
        n = len(towers)
        vp = img.get("view_pooling", {})
        ap = img.get("atomic_pooling", {})
        fu = img.get("fusion", {})
        drops_m = _as_list(img.get("drop_mod", 0), n)
        drops_3 = _as_list(img.get("drop_3d", 0), n)
        in_mod = _as_list(vp.get("in_mod"), n)
        out_mod = _as_list(vp.get("out_mod", vp.get("in_mod")), n)
        groups = _as_list(vp.get("num_groups", 1), n)
        pools = [_POOL_NAMES.get(p, vp.get("mode", "max"))
                 for p in _as_list(vp.get("module_name", "BimodalCSRPool"),
                                   n)]
        fusions = [{"concatenation": "concat"}.get(m, m)
                   for m in _as_list(fu.get("mode", "residual"), n)]
        for i in range(n):
            if str(towers[i]).startswith("shared:"):
                tower, deep = towers[i], False
                out_c = shared_tower[0][int(str(towers[i])[7:])]
            elif towers[i] == "ModalityIdentity":
                tower, deep = None, False     # raw-RGB gather/pool
                out_c = 3
            elif towers[i] == "reuse":
                # consume the (single) real tower's precomputed maps; the
                # fused width still follows the YAML's own in/out_mod
                tower, deep = "reuse", False
                out_c = resolve_constant(out_mod[i], constants, in_channels)
                if out_c is None:
                    out_c = resolve_constant(in_mod[i], constants,
                                             in_channels)
                if out_c is None:
                    real, rdeep = _tower_of(next(
                        t for t in towers if t not in
                        ("reuse", "ModalityIdentity")))
                    out_c = _TOWER_CHANNELS[real.split("_")[-1]]
            else:
                tower, deep = _tower_of(towers[i])
                out_c = resolve_constant(out_mod[i], constants, in_channels)
                if out_c is None:
                    out_c = resolve_constant(in_mod[i], constants,
                                             in_channels)
                if out_c is None:
                    # plain (un-learned) pools emit the tower's channels
                    out_c = _TOWER_CHANNELS[tower.split("_")[-1]]
                    if deep and tower == "resnet18_l0":
                        out_c = 128        # deep stem widens layer0
                    if deep and tower == "resnet18_pyramid_raw":
                        out_c = 1088       # 128-wide deep-stem tap
            branches.append((level_of(bidx[i]), BranchSpec(
                tower=tower,
                out_channels=int(out_c),
                atomic_reduce=ap.get("mode", "max"),
                view_pool=pools[i],
                num_groups=int(resolve_constant(groups[i], constants) or 1),
                interpolate=bool(img.get("interpolate", False)),
                fusion_mode=fusions[i],
                tower_deep_stem=deep,
                drop_modality=_drop_of(drops_m[i], constants),
                drop_3d=_drop_of(drops_3[i], constants),
                drop_hard=False,  # upstream never threads hard_drop
                **_pool_kwargs(vp, pools[i]),
            )))
    return ModelSpec(
        num_classes=num_classes,
        in_channels=in_channels,
        backbone=backbone,
        branches=tuple(branches),
        stem_kernel=stem_kernel,
        family=family,
        backbone_layers=layers,
        backbone_planes=planes,
        shared_tower=shared_tower,
    )


def _drop_of(v, constants) -> float:
    """A YAML drop value -> float p (0.0 for absent/None/'None')."""
    v = resolve_constant(v, constants)
    if v is None or isinstance(v, str) or not v:
        return 0.0
    return float(v)


def _scratch_tower_cfg(img: Dict, constants: Dict,
                       num_classes: int):
    """Inline ResNetDown/ResNetUp/last_conv DSL -> ``scratch2d.TowerCfg``.

    Mirrors the reference's compact-format image ``UNet`` assembly
    (modalities/image.py:546-572: one ResNetDown per down_conv_nn pair with
    per-stage kernel/stride/padding/N, one ResNetUp per up_conv_nn triple,
    optional UnaryConv last_conv — defaults kernel_size=2/stride=2/N=1/
    padding=0 from the module signatures, image.py:251-400).  The emitted
    towers therefore train with the parity-pinned ``UNetWS`` stack
    (modules/scratch2d.py), not a look-alike."""
    idc = img["down_conv"]
    n = _n_stages(idc)

    def stage_ints(node, key, default, count):
        return [int(resolve_constant(v, constants))
                for v in _as_list(node.get(key, default), count)]

    ks = stage_ints(idc, "kernel_size", 2, n)
    st = stage_ints(idc, "stride", 2, n)
    pd = stage_ints(idc, "padding", 0, n)
    nb = stage_ints(idc, "N", 1, n)
    down = tuple(
        (int(resolve_constant(pair[0], constants)),
         int(resolve_constant(pair[1], constants)),
         ks[i], st[i], pd[i], nb[i])
        for i, pair in enumerate(idc["down_conv_nn"]))
    up = None
    if "up_conv" in img:
        uc = img["up_conv"]
        m = _n_stages(uc)
        ksu = stage_ints(uc, "kernel_size", 2, m)
        stu = stage_ints(uc, "stride", 2, m)
        pdu = stage_ints(uc, "padding", 0, m)
        nbu = stage_ints(uc, "N", 1, m)
        up = tuple(
            (int(resolve_constant(t[0], constants)),
             int(resolve_constant(t[1], constants)),
             int(resolve_constant(t[2], constants)),
             ksu[i], stu[i], pdu[i], nbu[i])
            for i, t in enumerate(uc["up_conv_nn"]))
    last = None
    lc = img.get("last_conv")
    if lc is not None:
        # output_nc is usually the N_CLS constant (logit-fusion entries)
        out_nc = int(resolve_constant(lc["output_nc"], constants,
                                      num_classes))
        in_drop = _drop_of(lc.get("in_drop", 0), constants)
        if in_drop > 0:
            last = (out_nc, in_drop, bool(lc.get("persistent_drop", False)))
        else:
            last = out_nc
    return (down, up, last)


def _resolve_image_tower(img: Dict, mod: str, out_hint, constants: Dict,
                         num_classes: int) -> Dict:
    """BranchSpec tower kwargs for one image-branch module name — shared by
    the late-fusion and no3d spec builders.

    ResNetDown DSL stacks (with or without up_conv) emit the
    reference-exact ``scratch_unet`` tower with a TowerCfg parsed from the
    inline plan; truncation class names resolve via _tower_of with
    _TOWER_CHANNELS fallback.  NOTE the reference attaches ``last_conv``
    ONLY to UNet towers (unet.py:512-520 builds just ``down_conv`` for
    named-class modules), so non-UNet entries ignore it here too."""
    idc = img["down_conv"]
    if mod == "ResNetDown" and "down_conv_nn" in idc:
        cfg = _scratch_tower_cfg(img if "up_conv" in img
                                 else {"down_conv": idc}, constants,
                                 num_classes)
        from ..modules.scratch2d import tower_cfg_out_channels

        norm = {"GroupNorm": "group", "BatchNorm2d": "batch",
                "BatchNorm": "batch"}.get(
                    idc.get("normalization", "BatchNorm2d"), "batch")
        return dict(tower="scratch_unet", tower_cfg=cfg,
                    out_channels=tower_cfg_out_channels(cfg),
                    tower_norm=norm,
                    tower_ws=bool(idc.get("weight_standardization", False)))
    tower, deep = _tower_of(mod)
    out_c = resolve_constant(out_hint, constants)
    if not isinstance(out_c, (int, float)):
        out_c = _TOWER_CHANNELS[tower.split("_")[-1]]
    return dict(tower=tower, tower_deep_stem=deep, out_channels=int(out_c))


def _late_spec(entry: Dict, num_classes: int, in_channels: int,
               family: str) -> ModelSpec:
    """LateFeatureFusion / LateLogitFusion entries: separate ``backbone_3d``
    (a full 3D UNet) and ``backbone_no3d`` (an image UNet pooled to points),
    fused at features or logits (models/segmentation/multimodal/
    sparseconv3d.py LateFeatureFusion/LateLogitFusion)."""
    b3 = entry["backbone_3d"]
    c3 = dict(b3.get("define_constants", {}))
    down, up = b3["down_conv"], b3.get("up_conv", {})
    enc_n = tuple(int(x) for x in _as_list(down.get("N", []),
                                           _n_stages(down))[1:])
    backbone = _BACKBONES.get(enc_n)
    layers = planes = None
    if backbone is None:
        layers, planes = _extract_backbone_plan(down, up, c3, in_channels)
        backbone = "Res16UNet34"

    bn = entry["backbone_no3d"]
    cn = dict(bn.get("define_constants", {}))
    img = bn["down_conv"]["image"]
    vp = img.get("view_pooling", {})
    ap = img.get("atomic_pooling", {})
    idc = img["down_conv"]
    mods = idc.get("module_name", "ResNetDown")
    mods = mods if isinstance(mods, list) else [mods]
    n = len(mods)
    pools = [_POOL_NAMES.get(p, vp.get("mode", "max"))
             for p in _as_list(vp.get("module_name", "BimodalCSRPool"), n)]
    out_mod = _as_list(vp.get("out_mod", vp.get("in_mod")), n)
    groups = _as_list(vp.get("num_groups", 1), n)

    drops_m = _as_list(img.get("drop_mod", 0), n)
    drops_3 = _as_list(img.get("drop_3d", 0), n)
    branches: List[Tuple[int, BranchSpec]] = []
    for i in range(n):
        tkw = _resolve_image_tower(img, mods[i], out_mod[i], cn, num_classes)
        if pools[i] in ("group", "qkv"):
            om = resolve_constant(out_mod[i], cn)
            if isinstance(om, (int, float)):
                # learned pools project the tower features to out_mod
                tkw["out_channels"] = int(om)
        branches.append((0, BranchSpec(
            atomic_reduce=ap.get("mode", "max"),
            view_pool=pools[i],
            num_groups=int(resolve_constant(groups[i], cn) or 1),
            interpolate=bool(img.get("interpolate", False)),
            drop_modality=_drop_of(drops_m[i], cn),
            drop_3d=_drop_of(drops_3[i], cn),
            drop_hard=False,   # upstream never threads hard_drop (unet.py:543)
            **_pool_kwargs(vp, pools[i]),
            **tkw,
        )))
    return ModelSpec(
        num_classes=num_classes,
        in_channels=in_channels,
        backbone=backbone,
        family=family,
        branches=tuple(branches),
        backbone_layers=layers,
        backbone_planes=planes,
    )


def _no3d_spec(entry: Dict, num_classes: int, in_channels: int) -> ModelSpec:
    """No3D entries.  The LogitFusion classes (_HAS_HEAD=False,
    no3d.py:164-180) run headless when the tower itself emits N_CLS logits
    (scratch UNets whose last_conv output_nc is N_CLS — the executed
    configuration).  The one published non-UNet logit entry
    (RGB_ResNet18PPM_mean-logit_view) keeps a linear head here: upstream's
    builder discards last_conv for named-class towers (unet.py:512-520), so
    the executed reference model emits 512-wide 'logits' that cannot train —
    a config/runtime mismatch we do not reproduce."""
    img = entry["down_conv"]["image"]
    constants = dict(entry.get("define_constants", {}))
    ap = img.get("atomic_pooling", {})
    vp = img.get("view_pooling", {})
    mods = img["down_conv"].get("module_name", "ResNetDown")
    mods = mods if isinstance(mods, list) else [mods]
    n = len(mods)
    pools = [_POOL_NAMES.get(p, vp.get("mode", "mean"))
             for p in _as_list(vp.get("module_name", "BimodalCSRPool"), n)]
    out_mod = _as_list(vp.get("out_mod", vp.get("in_mod", 64)), n)
    drops_m = _as_list(img.get("drop_mod", 0), n)
    branches: List[Tuple[int, BranchSpec]] = []
    headless = False
    for i in range(n):
        tkw = _resolve_image_tower(img, mods[i], out_mod[i], constants,
                                   num_classes)
        if pools[i] in ("group", "qkv"):
            om = resolve_constant(out_mod[i], constants)
            if isinstance(om, (int, float)):
                tkw["out_channels"] = int(om)
        if ("LogitFusion" in entry.get("class", "")
                and tkw.get("out_channels") == num_classes
                and tkw.get("tower") == "scratch_unet"):
            headless = True
        branches.append((0, BranchSpec(
            atomic_reduce=ap.get("mode", "max"),
            view_pool=pools[i],
            num_groups=int(resolve_constant(
                _as_list(vp.get("num_groups", 1), n)[i], constants) or 1),
            interpolate=bool(img.get("interpolate", False)),
            drop_modality=_drop_of(drops_m[i], constants),
            drop_hard=False,   # upstream never threads hard_drop (unet.py:543)
            **_pool_kwargs(vp, pools[i]),
            **tkw,
        )))
    return ModelSpec(
        num_classes=num_classes,
        in_channels=in_channels,
        family="no3d",
        branches=tuple(branches),
        no3d_head=not headless,
    )


def _interp_data(doc, v):
    """Resolve ``${data.<dotted.path>}`` interpolations against the YAML doc
    (the subset of OmegaConf interpolation the published data configs use)."""
    seen = 0
    while isinstance(v, str) and v.startswith("${data.") and v.endswith("}"):
        node = doc
        for part in v[len("${data."):-1].split("."):
            if not isinstance(node, dict) or part not in node:
                return v  # unresolvable — leave verbatim
            node = node[part]
        v = node
        seen += 1
        if seen > 8:  # cycle guard
            break
    return v


def _chain_params(doc, chain, name: str) -> Optional[Dict]:
    """``params`` of the first ``transform: <name>`` entry in a transform
    list (None when the transform is absent; {} when present bare)."""
    chain = _interp_data(doc, chain)
    for t in chain or []:
        if isinstance(t, dict) and t.get("transform") == name:
            return {k: _interp_data(doc, v)
                    for k, v in (t.get("params") or {}).items()}
    return None


def _load_with_defaults(path: str, depth: int = 0) -> Dict:
    """Load a data YAML and merge its hydra ``defaults:`` bases underneath
    (child keys win) — the published configs use single-item absolute
    references like ``- /data/segmentation/kitti360-sparse``.  The conf
    root is the ancestor directory named ``conf``."""
    with open(path) as f:
        doc = safe_load(f.read()) or {}
    bases = doc.pop("defaults", None)
    if not bases or depth > 4:
        return doc
    root = os.path.dirname(os.path.abspath(path))
    while os.path.basename(root) != "conf" and root != "/":
        root = os.path.dirname(root)
    merged: Dict = {}
    for b in bases:
        if not isinstance(b, str) or not b.startswith("/"):
            continue
        bpath = os.path.join(root, b.lstrip("/") + ".yaml")
        if os.path.exists(bpath):
            merged.update(_load_with_defaults(bpath, depth + 1))
    merged.update(doc)
    return merged


def load_data_cfg(path: str) -> Dict:
    """A published multimodal data YAML -> ``cfg.data`` field dict.

    Scalar fields: ``first_subsampling``/``resolution_3d`` -> voxel_size;
    ``resolution_2d`` -> image_size; sphere/cylinder radius from the train
    sampler transform; ``train_pixel_credit`` -> image_slots and
    ``test_pixel_credit`` -> eval_image_slots (the reference evaluates with
    its own budget, s3disfused-sparse.yaml:109); ``min_size_2d`` ->
    crop_ladder_min; ``sample_per_epoch``; dataset kind from ``class``.

    The full mapping-factory / transform-chain parameterization lands under
    ``kwargs`` (consumed by the dataset factories via ``**cfg.data.kwargs``):

      * ``mapping_params`` — the preprocess-time mapping construction:
        MapImages r_max / r_min / k_swell / exact / proj_upscale / voxel
        (s3disfused-sparse.yaml:122-132, kitti360-sparse.yaml:88-99),
        NonStaticMask n_sample (:115-121), NeighborhoodBasedMappingFeatures
        k + density + occlusion (:133-141), CropImageGroups padding.
      * ``aug_params`` — the runtime augmentations: RandomNoise sigma,
        RandomRotate degrees/axis, RandomScaleAnisotropic scales,
        RandomSymmetry axes (3D, :49-63); JitterMappingFeatures sigma/clip,
        ColorJitter brightness/contrast/saturation, RandomHorizontalFlip,
        CenterRoll angular_res, PickImagesFromMappingArea use_bbox,
        PickImagesFromMemoryCredit k_coverage (2D, :144-170).

    So ``data.ref=<name>`` training consumes the reference's published
    pipeline parameters, not look-alike defaults.

    Hydra ``defaults:`` bases are merged underneath (kitti360-sparse
    inherits radius=6 / sample_per_epoch=12000 / resolution_3d from
    ``conf/data/segmentation/kitti360-sparse.yaml:11-15``).
    """
    doc = _load_with_defaults(path)

    def interp(v):
        return _interp_data(doc, v)

    out: Dict = {}
    cls = doc.get("class", "")
    out["dataset"] = ("s3dis" if "s3dis" in cls.lower() else
                      "scannet" if "scannet" in cls.lower() else
                      "kitti360" if "kitti" in cls.lower() else cls)
    vox = interp(doc.get("first_subsampling", doc.get("resolution_3d", 0.05)))
    out["voxel_size"] = float(vox)
    res2d = interp(doc.get("resolution_2d", [1024, 512]))
    out["image_size"] = [int(x) for x in res2d]
    if "sample_per_epoch" in doc:
        out["samples_per_epoch"] = int(doc["sample_per_epoch"])
    if "min_size_2d" in doc:
        out["crop_ladder_min"] = int(interp(doc["min_size_2d"]))
    mm = doc.get("multimodal", {})
    settings = dict(mm.get("settings", {}))
    # kitti360-sparse.yaml keeps the budget/mapping knobs at the top level
    # (referenced as ${data.x}); s3dis/scannet nest them under
    # multimodal.settings
    for k in ("train_pixel_credit", "test_pixel_credit", "k_coverage",
              "proj_upscale", "r_max", "r_min"):
        if k not in settings and k in doc:
            settings[k] = doc[k]
    if "train_pixel_credit" in settings:
        out["image_slots"] = int(interp(settings["train_pixel_credit"]))
    if "test_pixel_credit" in settings:
        out["eval_image_slots"] = int(interp(settings["test_pixel_credit"]))
    # sphere / cylinder radius from the train sampling transform
    for t in doc.get("train_transforms", []) or []:
        if t.get("transform") in ("RandomSphere", "RandomCylinder"):
            r = interp(t.get("params", {}).get("radius", 2.0))
            out["radius"] = float(r)
    if "radius" not in out and "radius" in doc:
        # outdoor datasets put the cylinder radius at the top level
        # (conf/data/segmentation/kitti360-sparse.yaml:11)
        out["radius"] = float(interp(doc["radius"]))
    out.setdefault("radius", 2.0)

    # ---- mapping-factory parameterization (preprocess-time) --------------
    mp: Dict = {}
    map_images = _chain_params(doc, mm.get("pre_transform"), "MapImages")
    if map_images is not None:
        for src, dst, cast in (("r_max", "r_max", float),
                               ("r_min", "r_min", float),
                               ("k_swell", "k_swell", float),
                               ("exact", "exact", bool),
                               ("proj_upscale", "proj_upscale", int)):
            if src in map_images:
                mp[dst] = cast(interp(map_images[src]))
    elif "exact_splatting_2d" in doc:
        mp["exact"] = bool(interp(doc["exact_splatting_2d"]))
    nsm = _chain_params(doc, mm.get("pre_transform"), "NonStaticMask")
    if nsm is not None and "n_sample" in nsm:
        mp["n_sample"] = int(interp(nsm["n_sample"]))
    nbf = _chain_params(doc, mm.get("pre_transform"),
                        "NeighborhoodBasedMappingFeatures")
    if nbf is not None:
        if "k" in nbf:
            mp["nbf_k"] = int(interp(nbf["k"]))
        for flag in ("density", "occlusion"):
            if flag in nbf:
                mp[flag] = bool(interp(nbf[flag]))
    crop = _chain_params(doc, mm.get("train_transforms"), "CropImageGroups")
    if crop is not None and "padding" in crop:
        mp["crop_padding"] = int(interp(crop["padding"]))

    # ---- runtime augmentation parameterization ---------------------------
    ap: Dict = {}
    noise = _chain_params(doc, doc.get("train_transforms"), "RandomNoise")
    if noise is not None:
        ap["noise_sigma"] = float(interp(noise.get("sigma", 0.01)))
    rot = _chain_params(doc, doc.get("train_transforms"), "RandomRotate")
    if rot is not None:
        ap["rotate_axis"] = int(interp(rot.get("axis", 2)))
        ap["rotate_degrees"] = float(interp(rot.get("degrees", 180)))
    scale = _chain_params(doc, doc.get("train_transforms"),
                          "RandomScaleAnisotropic")
    if scale is not None and "scales" in scale:
        ap["scales"] = [float(s) for s in interp(scale["scales"])]
    sym = _chain_params(doc, doc.get("train_transforms"), "RandomSymmetry")
    if sym is not None and "axis" in sym:
        ap["symmetry_axes"] = [bool(a) for a in interp(sym["axis"])]
    mm_train = mm.get("train_transforms")
    jit = _chain_params(doc, mm_train, "JitterMappingFeatures")
    if jit is not None:
        ap["jitter_mapping"] = float(interp(jit.get("sigma", 0.02)))
        ap["jitter_clip"] = float(interp(jit.get("clip", 0.03)))
    cj = _chain_params(doc, mm_train, "ColorJitter")
    if cj is not None:
        ap["color_jitter"] = [float(interp(cj.get(k, 0.0)))
                              for k in ("brightness", "contrast",
                                        "saturation")]
    if _chain_params(doc, mm_train, "RandomHorizontalFlip") is not None:
        ap["flip_p"] = 0.5
    roll = _chain_params(doc, mm_train, "CenterRoll")
    if roll is not None:
        ap["center_roll"] = True
        if "angular_res" in roll:
            ap["roll_angular_res"] = int(interp(roll["angular_res"]))
    area = _chain_params(doc, mm_train, "PickImagesFromMappingArea")
    if area is not None and "use_bbox" in area:
        ap["use_bbox"] = bool(interp(area["use_bbox"]))
    credit = _chain_params(doc, mm_train, "PickImagesFromMemoryCredit")
    if credit is not None and "k_coverage" in credit:
        ap["k_coverage"] = int(interp(credit["k_coverage"]))

    kwargs: Dict = {}
    if mp:
        kwargs["mapping_params"] = mp
    if ap:
        kwargs["aug_params"] = ap
    # dataset-class knobs exposed at the YAML top level
    if "fold" in doc:
        kwargs["fold"] = int(interp(doc["fold"]))
    # the reference subsamples the image stream by ratio
    # (kitti360-sparse.yaml:16 image_ratio=5: one of every 5 frames)
    for k in ("frame_skip", "image_ratio"):
        if k in doc:
            kwargs["frame_step"] = int(interp(doc[k]))
            break
    if kwargs:
        out["kwargs"] = kwargs
    return out
