"""The multimodal segmentation model (DeepViewAgg).

The port of ``deepviewagg_tpu/models/segmentation.py`` (``BranchSpec``,
``ModelSpec``, ``make_tower``, ``MultimodalSeg``, ``SparseConv3dSeg``,
``No3DSeg``, ``LateFusionSeg``, ``build_model``; the reference's
models/segmentation/{sparseconv3d,multimodal/sparseconv3d,multimodal/no3d}
.py): a Res16UNet whose encoder levels interleave image branches, the 3D-only
UNet, the 2D-only No3D models and the late-fusion models.  A branch at level
L consumes ``batch['mappings'][L]`` (level-0 mappings merged through the
stride chain at collate time).

The batch contract is the collated dict moved to the device by
:func:`deepviewagg_tpu_torch.data.collate.batch_to_torch`: ``feats [P0, Cin]``,
``graph`` (per level: valid / batch_idx / sub_nbr / down_nbr / up_nbr /
parent) and either a flat image batch, ``images [I, W, H, 3]`` with
``mappings {level: mapping dict}``, or a crop-ladder batch
(``Bucket.image_ladder``), ``bucket_images [per ladder size: [Ib, w, h, 3]]``
with ``mappings {level: {"view": ..., "buckets": [...]}}``.  One set of
parameters serves both: a ladder batch goes through
:class:`~deepviewagg_tpu_torch.modules.multibucket.MultiBucketBranch` over the
branch's own tower, view pool and fusion.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..modules import image_encoders as towers
from ..modules.branch import UnimodalBranch, soft_dropout
from ..modules.multibucket import MultiBucketBranch
from ..nn.res16unet import RES16_PRESETS, DownStage, Res16UNet, Stem, UpStage
from ..utils import trace

__all__ = ["BranchSpec", "ModelSpec", "MultimodalSeg", "SparseConv3dSeg",
           "No3DSeg", "LateFusionSeg", "build_model", "make_tower",
           "init_parameters"]


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """One image branch (the JAX package's ``BranchSpec``, same fields)."""

    tower: str = "resnet18_l4"
    out_channels: int = 64
    atomic_reduce: str = "max"
    view_pool: str = "group"
    num_groups: int = 1
    use_mod: bool = False
    gated: bool = True
    interpolate: bool = True
    drop_modality: float = 0.0
    drop_3d: float = 0.0
    fusion_mode: str = "residual"
    remat_tower: Any = "convs"
    tower_norm: str = "group"
    tower_deep_stem: bool = False
    drop_hard: bool = True
    frozen: bool = False
    tower_bf16: bool = True
    pool_bf16: bool = False
    set_encoder: str = "deepset"
    pool_use_num: bool = True
    pool_scaling: bool = True
    qk_channels: int = 8
    use_mod_q: bool = False
    use_mod_k: bool = False
    dim_scaling: bool = True
    pool_modes: Tuple[str, ...] = ("max",)
    pool_fusion: str = "concatenation"
    tower_cfg: Optional[Tuple] = None
    tower_ws: bool = True


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Named-model description (the JAX package's ``ModelSpec``)."""

    num_classes: int
    in_channels: int = 4
    backbone: str = "Res16UNet34"
    branches: Tuple[Tuple[int, BranchSpec], ...] = ()  # (level, spec)
    head_dropout: float = 0.0
    family: str = "unet"
    stem_kernel: int = 3
    backbone_layers: Optional[Tuple[int, ...]] = None
    backbone_planes: Optional[Tuple[int, ...]] = None
    backbone_block: str = "basic"
    shared_tower: Optional[Tuple] = None
    no3d_head: bool = True

    def branch_levels(self):
        """level -> [BranchSpec, ...]."""
        out: Dict[int, list] = {}
        for lvl, b in self.branches:
            out.setdefault(lvl, []).append(b)
        return out


def backbone_plan(spec: ModelSpec):
    """``(layers, planes, block)`` of a spec's Res16UNet: its own plan, else
    the named preset's."""
    if spec.backbone_layers is not None:
        return spec.backbone_layers, spec.backbone_planes, spec.backbone_block
    return RES16_PRESETS[spec.backbone]


def make_tower(name: str, norm: str = "group", deep_stem: bool = False,
               device=None, tower_cfg=None, ws: bool = True):
    """Tower registry -> (module, out_channels): ``resnet18_ppm``,
    ``resnet18_pyramid`` (the shared pyramid projected to 128 channels),
    ``resnet18_pyramid_raw`` (its raw tap concat), the ``resnet18_l<level>``
    truncations (7x7 or deep stem), ``scratch_unet`` (the reference-exact
    compact tower of ``tower_cfg``, weight-standardized with ``ws``),
    ``unet2d_light`` (the light no3d UNet, 32 channels),
    ``unet2d[_<channels>]`` and ``None`` (no tower: the branch pools the
    images' 3 channels).  ``"reuse"`` and ``"shared:<i>"`` are
    :class:`MultimodalSeg`'s and raise ``KeyError`` here.  ``norm``:
    ``'group'`` (GroupNorm, the ResNet towers' convs weight-standardized) or
    ``'batch'`` (BatchNorm after plain convs: the towers that take
    pretrained weights)."""
    if norm not in ("group", "batch"):
        raise ValueError(f"tower_norm {norm!r}")
    if name == "scratch_unet":
        from ..modules.scratch2d import tower_cfg_out_channels, unetws_from_cfg

        if tower_cfg is None:
            raise ValueError("scratch_unet needs BranchSpec.tower_cfg")
        return (unetws_from_cfg(tower_cfg, norm=norm, ws=ws, device=device),
                tower_cfg_out_channels(tower_cfg))
    if name is None:
        # tower-less branch: gather/pool the raw image channels (the
        # reference's ModalityIdentity)
        return None, 3
    if name == "resnet18_ppm":
        return towers.ResNet18PPM(out_channels=128, deep_stem=deep_stem,
                                  norm=norm, device=device), 128
    if name in ("resnet18_pyramid", "resnet18_pyramid_raw"):
        tower = towers.ResNet18Pyramid(
            out_channels=128, deep_stem=deep_stem,
            project=name == "resnet18_pyramid", norm=norm, device=device)
        return tower, tower.out_channels
    if name.startswith("resnet18_l"):
        lvl = int(name[-1])
        # the deep stem widens layer0 to 128 (MIT resnet.py)
        return (towers.ResNet18(out_level=lvl, deep_stem=deep_stem,
                                norm=norm, device=device),
                128 if deep_stem and lvl == 0 else towers.OUT_CHANNELS[lvl])
    if name == "unet2d_light":
        # the published no3d light tower (no3d.yaml:5-50): 5 down stages
        # 32/32/64/128/256, up back to 32
        return towers.UNet2D(down_widths=(32, 32, 64, 128, 256),
                             up_widths=(128, 96, 64, 32), out_channels=32,
                             norm=norm, device=device), 32
    if name.startswith("unet2d"):
        # "unet2d" or "unet2d_<out_channels>" (ref image.py:510)
        out = int(name.split("_")[1]) if "_" in name else 32
        return towers.UNet2D(out_channels=out, norm=norm,
                             device=device), out
    raise KeyError(name)


_VIEW_POOLS = ("group", "qkv", "heuristic", "max", "mean", "min", "sum", "add")


def _check_branch(spec: BranchSpec) -> None:
    """Every view pool and set encoder that the JAX package builds."""
    if spec.view_pool not in _VIEW_POOLS:
        raise ValueError(f"view_pool {spec.view_pool!r}")
    if spec.set_encoder not in ("deepset", "minmaxdiff", "mlp"):
        raise ValueError(f"set_encoder {spec.set_encoder!r}")


def _spec_tower(b: BranchSpec, device):
    """``make_tower`` of a branch spec's own tower."""
    return make_tower(b.tower, b.tower_norm, b.tower_deep_stem,
                      device=device, tower_cfg=b.tower_cfg, ws=b.tower_ws)


def _branch(b: BranchSpec, channels_3d: int, device, feeds=None, **changes):
    """The ``UnimodalBranch`` of a branch spec over its own tower, or,
    with ``feeds`` (its channels), over no tower: it then takes feature
    maps made outside it (a shared trunk's tap, a reused tower's maps)."""
    _check_branch(b)
    if feeds is None:
        tower, c2 = _spec_tower(b, device)
    else:
        tower, c2 = None, feeds
    kw = dict(
        atomic_reduce=b.atomic_reduce, view_pool=b.view_pool,
        num_groups=b.num_groups, use_mod=b.use_mod,
        set_encoder=b.set_encoder, pool_use_num=b.pool_use_num,
        pool_scaling=b.pool_scaling, pool_modes=b.pool_modes,
        pool_fusion=b.pool_fusion, qk_channels=b.qk_channels,
        use_mod_q=b.use_mod_q, use_mod_k=b.use_mod_k,
        dim_scaling=b.dim_scaling, gated=b.gated, interpolate=b.interpolate,
        drop_modality=b.drop_modality, drop_3d=b.drop_3d,
        drop_hard=b.drop_hard, fusion_mode=b.fusion_mode,
        tower_bf16=b.tower_bf16, pool_bf16=b.pool_bf16,
        remat_tower=b.remat_tower, frozen=b.frozen)
    kw.update(changes)
    return UnimodalBranch(tower, c2, channels_3d, b.out_channels,
                          device=device, **kw)


class MultimodalSeg(nn.Module):
    """DeepViewAgg: Res16UNet with image branches interleaved at encoder
    levels; ``forward(batch, generator=None)`` returns ``{"logits",
    "x_seen"}`` in training and eval mode alike.  ``generator`` feeds every
    dropout (modality, 3D and head); without one they are the identity.

    Besides a branch with its own tower, the three kinds that only reference
    ingest builds: a tower-less branch (``tower=None``: the raw image
    channels, flat and crop-ladder batches alike), the shared trunk
    (``spec.shared_tower``: ``shared_tower``, run once a forward, its tap
    ``i`` feeding the branch that says ``"shared:<i>"``) and tower reuse
    (``reuse_tower``, built from the first branch with a real tower and run
    once a forward, feeding that branch and every ``"reuse"`` one).  These
    branches own no ``tower``; shared and reuse take flat batches only.

    Traced (``utils/trace.py``): each branch a ``model.branch`` span, the
    stem through the last decoder stage ``model.unet``, both timed on the
    device too; a shared trunk or reused tower a ``branch.tower``."""

    def __init__(self, spec: ModelSpec, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.spec = spec
        self._ladder: Dict[str, nn.Module] = {}   # see _ladder_branch
        layers, planes, block = backbone_plan(spec)
        self.n_down = n_down = len(layers) // 2
        branch_at = spec.branch_levels()
        # the branches fed from outside them, name -> ("shared", tap) or
        # ("reuse",): see _feeds
        self._fed: Dict[str, tuple] = {}
        # shared progressive trunk (Res16Image families): ONE encoder runs
        # once a forward; its stage-i tap is gathered/pooled at the level
        # whose branch says tower="shared:i"
        self._shared_by = self._reuse_by = None
        if spec.shared_tower is not None:
            widths, blocks, strides = spec.shared_tower
            self._shared_by = next(b for _, b in spec.branches
                                   if str(b.tower).startswith("shared:"))
            self.shared_tower = towers.ConvDown2D(
                tuple(widths), tuple(blocks), tuple(strides), device=device)
        # single-tower reuse (XYZ-RGB-L4-all): the first real tower runs once
        # a forward and every branch with a tower, the one that declares it
        # included, gathers/pools its maps at its own level
        if any(str(b.tower) == "reuse" for _, b in spec.branches):
            self._reuse_by = next((b for _, b in spec.branches
                                   if b.tower not in (None, "reuse")), None)
            if self._reuse_by is None:
                raise ValueError("tower-reuse branches need a branch with "
                                 "a tower of its own")
            self.reuse_tower, self._reuse_channels = _spec_tower(
                self._reuse_by, device)

        def add_branches(level, c):
            for k, b in enumerate(branch_at.get(level, ())):
                name = f"branch_l{level}" if k == 0 else f"branch_l{level}_{k}"
                feeds = None
                if str(b.tower).startswith("shared:"):
                    tap = int(b.tower[len("shared:"):])
                    self._fed[name] = ("shared", tap)
                    feeds = self.shared_tower.tap_channels[tap]
                elif self._reuse_by is not None and b.tower is not None:
                    self._fed[name] = ("reuse",)
                    feeds = self._reuse_channels
                branch = _branch(b, c, device, feeds=feeds)
                setattr(self, name, branch)
                c = branch.out_channels
            return c

        c = add_branches(0, spec.in_channels)
        self.stem = Stem(c, 32, spec.stem_kernel, device=device)
        c, skip_c = 32, [32]
        for i in range(n_down):
            setattr(self, f"down{i}", DownStage(c, planes[i], layers[i], block,
                                                device=device))
            c = add_branches(i + 1, planes[i])
            if i < n_down - 1:
                skip_c.append(c)
        for j in range(n_down):
            setattr(self, f"up{j}", UpStage(
                c, skip_c[n_down - 1 - j], planes[n_down + j],
                layers[n_down + j], block, device=device))
            c = planes[n_down + j]
        self.head = nn.Linear(c, spec.num_classes, device=device)
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def _ladder_branch(self, name: str, branch: nn.Module) -> nn.Module:
        """The branch that takes crop-ladder batches: the ladder form of a
        ``UnimodalBranch`` over the same sub-modules (built once, kept
        outside the module tree so that the parameters are registered
        once)."""
        ladder = self._ladder.get(name)
        if ladder is None:
            ladder = self._ladder[name] = MultiBucketBranch.over(branch)
        ladder.training = branch.training
        return ladder

    def _feeds(self, batch, generator) -> Dict[str, Any]:
        """The shared trunk's taps (``"shared"``) and the reused tower's
        maps (``"reuse"``) of this forward, each run once; both need a
        flat image batch.  Like the JAX model, a tap is the float32 output
        of ``run_tower`` and is not cast again by the branch."""
        images = batch.get("images")   # absent on crop-ladder batches
        out: Dict[str, Any] = {}
        if self.spec.shared_tower is not None:
            if images is None:
                raise ValueError(
                    "shared_tower needs a flat image batch; crop-ladder "
                    "(bucketed) collate is not supported with shared trunks")
            sb = self._shared_by
            with trace.span("branch.tower", device=images):
                out["shared"] = towers.run_tower(
                    self.shared_tower, images, self.training,
                    remat=sb.remat_tower, frozen=sb.frozen,
                    bf16=sb.tower_bf16, generator=generator)
        if self._reuse_by is not None:
            if images is None:
                raise ValueError(
                    "tower-reuse branches need a flat image batch; "
                    "crop-ladder (bucketed) collate is not supported")
            ob = self._reuse_by
            with trace.span("branch.tower", device=images):
                out["reuse"] = towers.run_tower(
                    self.reuse_tower, images, self.training,
                    remat=ob.remat_tower, frozen=ob.frozen,
                    bf16=ob.tower_bf16, generator=generator)
        return out

    def _run_branches(self, level, x, batch, seen_all, feeds, generator):
        k = 0
        while True:
            name = f"branch_l{level}" if k == 0 else f"branch_l{level}_{k}"
            branch = getattr(self, name, None)
            if branch is None:
                return x, seen_all
            mm = batch["mappings"][level]
            with trace.span("model.branch", device=batch["feats"]):
                if "buckets" in mm:
                    # crop-group families (Bucket.image_ladder collate path)
                    x, seen = self._ladder_branch(name, branch)(
                        x, mm, bucket_images=batch.get("bucket_images"),
                        generator=generator)
                else:
                    images = batch["images"]
                    fed = self._fed.get(name)
                    maps = (images if fed is None else feeds["reuse"]
                            if fed[0] == "reuse" else feeds["shared"][fed[1]])
                    # pixel coords live at the images' size; the gather
                    # rescales them to a tap's
                    x, seen = branch(x, maps, mm,
                                     (images.shape[1], images.shape[2]),
                                     generator=generator)
            seen_all = seen if seen_all is None else (seen_all | seen)
            k += 1

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        graph = batch["graph"]
        feeds = self._feeds(batch, generator)
        x, x_seen = self._run_branches(0, batch["feats"], batch, None, feeds,
                                       generator)
        with trace.span("model.unet", device=batch["feats"]):
            x = self.stem(x, graph)
            skips = [x]
            for i in range(self.n_down):
                x = getattr(self, f"down{i}")(x, graph, i)
                x, _ = self._run_branches(i + 1, x, batch, None, feeds,
                                          generator)
                if i < self.n_down - 1:
                    skips.append(x)
            for j in range(self.n_down):
                lvl_out = self.n_down - 1 - j
                x = getattr(self, f"up{j}")(x, skips[lvl_out], graph, lvl_out)
        # the generator's presence (not the training flag) gates the head
        # dropout, so MC-dropout voting works at eval
        x = soft_dropout(x, self.spec.head_dropout, generator)
        out = {"logits": self.head(x)}
        if x_seen is not None:
            out["x_seen"] = x_seen
        return out


class SparseConv3dSeg(nn.Module):
    """3D-only sparse UNet + linear classification head (the reference's
    ``sparseconv3d.APIModel``, models/segmentation/sparseconv3d.py:15-59);
    ``forward(batch, generator=None)`` returns ``{"logits"}``."""

    def __init__(self, spec: ModelSpec, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.spec = spec
        self.backbone = Res16UNet(spec.in_channels, *backbone_plan(spec),
                                  stem_kernel=spec.stem_kernel, device=device)
        self.head = nn.Linear(self.backbone.out_channels, spec.num_classes,
                              device=device)
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        x = self.backbone(batch["feats"], batch["graph"])
        # the generator's presence (not the training flag) gates the head
        # dropout, so MC-dropout voting works at eval
        x = soft_dropout(x, self.spec.head_dropout, generator)
        return {"logits": self.head(x)}


class No3DSeg(nn.Module):
    """2D towers pooled straight onto points: the No3D*Fusion family
    (models/segmentation/multimodal/no3d.py:18).  The branches (``branch``,
    ``branch_1`` ...) pool their towers' features to the points; the pooled
    features are concatenated and go through a linear ``head`` (the
    FeatureFusion classes), or straight out when ``spec.no3d_head`` is False
    (the LogitFusion classes, whose towers emit class logits per pixel).
    Unseen points get zero features.  ``forward(batch, generator=None)``
    returns ``{"logits", "x_seen", "view_extras"}`` (branch 0's view-level
    tensors) and ``view_logits`` (the per-view features through the same
    head) where the per-view features have the pooled width."""

    def __init__(self, spec: ModelSpec, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.spec = spec
        self.levels = []
        width = 0
        for k, (level, b) in enumerate(spec.branches):
            # no 3D stream: a qkv pool raises, a 3D dropout does nothing
            branch = _branch(b, 0, device, fusion_mode="modality",
                             keep_last_view=k == 0)
            setattr(self, _family_branch_name(k), branch)
            self.levels.append(level)
            width += branch.out_channels
        self.head = (nn.Linear(width, spec.num_classes, device=device)
                     if spec.no3d_head else None)
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        ref_size = (images.shape[1], images.shape[2])
        num_points = batch["feats"].shape[0]
        pooled, x_seen, extras = [], None, None
        for k, level in enumerate(self.levels):
            out = getattr(self, _family_branch_name(k))(
                None, images, batch["mappings"][level], ref_size,
                num_points=num_points, generator=generator)
            pooled.append(out[0])
            x_seen = out[1] if x_seen is None else (x_seen | out[1])
            if k == 0:
                extras = out[2]
        pooled = pooled[0] if len(pooled) == 1 else torch.cat(pooled, dim=-1)
        head = self.head if self.head is not None else (lambda t: t)
        out = {"logits": head(pooled), "x_seen": x_seen,
               "view_extras": extras}
        # per-view logits through the SAME head (the view-level loss,
        # no3d.py:139-155), only where the saved per-view features share the
        # pooled width (plain reductions; attention pools save the tower's
        # features before their projection)
        if extras["x_view"].shape[-1] == pooled.shape[-1]:
            out["view_logits"] = head(extras["x_view"])
        return out


class LateFusionSeg(nn.Module):
    """A 3D UNet over the points and image branches pooled to the points,
    fused at the end (the reference's ``LateFeatureFusion`` /
    ``LateLogitFusion``, models/segmentation/multimodal/sparseconv3d.py:12,
    184): ``'feature'`` concatenates the UNet's features and every branch's
    pooled ones, then ``mix`` (linear to the UNet's width) -> ReLU ->
    ``head``; ``'logit'`` adds ``head3d`` of the UNet's features and, on
    seen points, the sum of each branch's ``head2d[_k]``.  Each branch gets
    the UNet's output as its 3D stream (the QKV pools' queries).
    ``forward(batch, generator=None)`` returns ``{"logits", "x_seen"}``."""

    def __init__(self, spec: ModelSpec, mode: str = "feature", device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        if mode not in ("feature", "logit"):
            raise ValueError(mode)
        if any(level != 0 for level, _ in spec.branches):
            raise ValueError("late fusion consumes level-0 mappings")
        self.spec, self.mode = spec, mode
        self.backbone = Res16UNet(spec.in_channels, *backbone_plan(spec),
                                  stem_kernel=spec.stem_kernel, device=device)
        c3 = self.backbone.out_channels
        n = spec.num_classes
        widths = []
        for k, (_, b) in enumerate(spec.branches):
            branch = _branch(b, c3, device, fusion_mode="modality")
            setattr(self, _family_branch_name(k), branch)
            widths.append(branch.out_channels)
        self.n_branches = len(widths)
        if mode == "logit":
            self.head3d = nn.Linear(c3, n, device=device)
            for k, w in enumerate(widths):
                setattr(self, "head2d" if k == 0 else f"head2d_{k}",
                        nn.Linear(w, n, device=device))
        else:
            self.mix = nn.Linear(c3 + sum(widths), c3, device=device)
            self.head = nn.Linear(c3, n, device=device)
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        x3d = self.backbone(batch["feats"], batch["graph"])
        images = batch["images"]
        ref_size = (images.shape[1], images.shape[2])
        x2d, x_seen = [], None
        for k in range(self.n_branches):
            out, seen = getattr(self, _family_branch_name(k))(
                x3d, images, batch["mappings"][0], ref_size,
                generator=generator)
            x2d.append(out)
            x_seen = seen if x_seen is None else (x_seen | seen)
        if self.mode == "logit":
            l2 = sum(getattr(self, "head2d" if k == 0 else f"head2d_{k}")(x)
                     for k, x in enumerate(x2d))
            logits = self.head3d(x3d) + torch.where(x_seen[:, None], l2, 0.0)
        else:
            h = torch.relu(self.mix(torch.cat([x3d] + x2d, dim=-1)))
            logits = self.head(h)
        return {"logits": logits, "x_seen": x_seen}


def _family_branch_name(k: int) -> str:
    """The k-th branch's name in the no3d and late-fusion families."""
    return "branch" if k == 0 else f"branch_{k}"


def build_model(spec: ModelSpec, device="cuda",
                seed: Optional[int] = 0) -> nn.Module:
    """The model of a spec (JAX ``build_model``): a PTv3 for the family
    ``ptv3`` and a PTv2 for ``ptv2`` (the port's own, :mod:`..nn.ptv3`,
    :mod:`..nn.ptv2`), ``SparseConv3dSeg``
    without branches, else by family ``No3DSeg`` (``no3d``),
    ``LateFusionSeg`` (``late_feature`` / ``late_logit``) or
    ``MultimodalSeg``."""
    if spec.family == "ptv3":
        from ..nn.ptv3 import PTV3_PRESETS, PointTransformerV3Seg

        return PointTransformerV3Seg(PTV3_PRESETS[spec.backbone],
                                     spec.in_channels, spec.num_classes,
                                     device=device, seed=seed)
    if spec.family == "ptv2":
        from ..nn.ptv2 import PTV2_PRESETS, PointTransformerV2Seg

        return PointTransformerV2Seg(PTV2_PRESETS[spec.backbone],
                                     spec.in_channels, spec.num_classes,
                                     device=device, seed=seed)
    if not spec.branches:
        return SparseConv3dSeg(spec, device=device, seed=seed)
    if spec.family == "no3d":
        return No3DSeg(spec, device=device, seed=seed)
    if spec.family in ("late_feature", "late_logit"):
        return LateFusionSeg(spec, mode=spec.family[len("late_"):],
                             device=device, seed=seed)
    return MultimodalSeg(spec, device=device, seed=seed)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialization, drawn on the CPU so one seed gives the
    same weights on every device: He-normal sparse, KPConv and 2D conv
    kernels (fan-in), the scratch towers' convs uniform with variance 1/(3
    fan-in), LeCun-normal linear weights and 3D conv kernels, zero biases, unit norm scales, and fresh
    running statistics (the flax initializers' families)."""
    from ..modules.image_encoders import BatchNorm, Conv2dWS
    from ..modules.pooling import Gating
    from ..modules.scratch2d import WSConv2d, WSConvTranspose2d
    from ..nn.kpconv import KPConvLayer
    from ..nn.norm import MaskedBatchNorm
    from ..nn.sparse_blocks import SparseConv

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (SparseConv, KPConvLayer)):
            k, cin, _ = m.weight.shape
            normal_(m.weight, float(np.sqrt(2.0 / (k * cin))))
        elif isinstance(m, nn.Conv3d):
            # LeCun normal, flax Conv's default; fan in = kd * kh * kw * cin
            normal_(m.weight, float(np.sqrt(1.0 / m.weight[0].numel())))
        elif isinstance(m, Conv2dWS):
            normal_(m.weight, float(np.sqrt(2.0 / m.weight[0].numel())))
        elif isinstance(m, (WSConv2d, WSConvTranspose2d)):
            # variance_scaling(1/3, fan_in, uniform); fan in = kh * kw * cin
            # (the transposed kernel's fan in counts its out channels)
            limit = float(np.sqrt(1.0 / m.weight[0].numel()))
            m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                            * 2.0 - 1.0) * limit)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            normal_(m.weight, float(np.sqrt(1.0 / m.in_features)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (MaskedBatchNorm, BatchNorm, nn.GroupNorm,
                            Gating)):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, (MaskedBatchNorm, BatchNorm)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
