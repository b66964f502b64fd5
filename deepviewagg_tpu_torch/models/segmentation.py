"""The multimodal segmentation model (DeepViewAgg).

The port of ``deepviewagg_tpu/models/segmentation.py`` (``BranchSpec``,
``ModelSpec``, ``make_tower``, ``MultimodalSeg``; the reference's
models/segmentation/multimodal/sparseconv3d.py): a Res16UNet whose encoder
levels interleave image branches.  A branch at level L consumes
``batch['mappings'][L]`` (level-0 mappings merged through the stride chain
at collate time).

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
from ..nn.res16unet import RES16_PRESETS, DownStage, Stem, UpStage

__all__ = ["BranchSpec", "ModelSpec", "MultimodalSeg", "make_tower",
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


def make_tower(name: str, norm: str = "group", deep_stem: bool = False,
               device=None):
    """Tower registry -> (module, out_channels) for the ported towers:
    ``resnet18_ppm`` and the ``resnet18_l<level>`` truncations."""
    if norm != "group" or deep_stem:
        raise NotImplementedError(
            "only group-norm towers with the 7x7 stem are ported yet")
    if name == "resnet18_ppm":
        return towers.ResNet18PPM(out_channels=128, device=device), 128
    if name.startswith("resnet18_l"):
        lvl = int(name[-1])
        return (towers.ResNet18(out_level=lvl, device=device),
                towers.OUT_CHANNELS[lvl])
    raise NotImplementedError(f"tower {name!r} is not ported yet")


def _check_branch(spec: BranchSpec) -> None:
    unsupported = {
        "view_pool": spec.view_pool not in ("group", "max", "mean", "min",
                                            "sum", "add"),
        "set_encoder": spec.set_encoder != "deepset",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"branch options not ported yet: {bad}")


class MultimodalSeg(nn.Module):
    """DeepViewAgg: Res16UNet with image branches interleaved at encoder
    levels; ``forward(batch, generator=None)`` returns ``{"logits",
    "x_seen"}`` in training and eval mode alike.  ``generator`` feeds every
    dropout (modality, 3D and head); without one they are the identity."""

    def __init__(self, spec: ModelSpec, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if spec.family != "unet" or spec.shared_tower is not None:
            raise NotImplementedError(f"model family {spec.family!r} with "
                                      "these options is not ported yet")
        self.spec = spec
        self._ladder: Dict[str, nn.Module] = {}   # see _ladder_branch
        if spec.backbone_layers is not None:
            layers, planes = spec.backbone_layers, spec.backbone_planes
            block = spec.backbone_block
        else:
            layers, planes, block = RES16_PRESETS[spec.backbone]
        self.n_down = n_down = len(layers) // 2
        branch_at = spec.branch_levels()

        def add_branches(level, c):
            for k, b in enumerate(branch_at.get(level, ())):
                _check_branch(b)
                if str(b.tower).startswith("shared:") or b.tower in (None, "reuse"):
                    raise NotImplementedError(f"tower {b.tower!r} is not ported yet")
                tower, c2 = make_tower(b.tower, b.tower_norm,
                                       b.tower_deep_stem, device=device)
                if b.view_pool == "group":
                    branch = UnimodalBranch(
                        tower, c2, c, b.out_channels,
                        atomic_reduce=b.atomic_reduce,
                        num_groups=b.num_groups, use_mod=b.use_mod,
                        pool_use_num=b.pool_use_num,
                        pool_scaling=b.pool_scaling, pool_modes=b.pool_modes,
                        pool_fusion=b.pool_fusion, gated=b.gated,
                        interpolate=b.interpolate,
                        drop_modality=b.drop_modality, drop_3d=b.drop_3d,
                        drop_hard=b.drop_hard, fusion_mode=b.fusion_mode,
                        tower_bf16=b.tower_bf16, pool_bf16=b.pool_bf16,
                        remat_tower=b.remat_tower, frozen=b.frozen,
                        device=device)
                else:
                    # the parameter-free segment pools are ported for
                    # crop-ladder batches only
                    branch = MultiBucketBranch(
                        tower, c2, c, b.out_channels,
                        atomic_reduce=b.atomic_reduce, view_pool=b.view_pool,
                        interpolate=b.interpolate, fusion_mode=b.fusion_mode,
                        frozen=b.frozen, remat_tower=b.remat_tower,
                        tower_bf16=b.tower_bf16, pool_bf16=b.pool_bf16,
                        device=device)
                name = f"branch_l{level}" if k == 0 else f"branch_l{level}_{k}"
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
        """The branch that takes crop-ladder batches: ``branch`` itself, or
        the ladder form of a ``UnimodalBranch`` over the same sub-modules
        (built once, kept outside the module tree so that the parameters are
        registered once)."""
        if isinstance(branch, MultiBucketBranch):
            return branch
        ladder = self._ladder.get(name)
        if ladder is None:
            ladder = self._ladder[name] = MultiBucketBranch.over(branch)
        ladder.training = branch.training
        return ladder

    def _run_branches(self, level, x, batch, seen_all, generator):
        k = 0
        while True:
            name = f"branch_l{level}" if k == 0 else f"branch_l{level}_{k}"
            branch = getattr(self, name, None)
            if branch is None:
                return x, seen_all
            mm = batch["mappings"][level]
            if "buckets" in mm:
                # crop-group families (Bucket.image_ladder collate path)
                x, seen = self._ladder_branch(name, branch)(
                    x, mm, bucket_images=batch.get("bucket_images"))
            elif isinstance(branch, MultiBucketBranch):
                raise NotImplementedError(
                    f"view_pool {branch.view_pool.reduce!r} on a flat image "
                    "batch is not ported yet")
            else:
                images = batch["images"]
                x, seen = branch(x, images, mm,
                                 (images.shape[1], images.shape[2]),
                                 generator=generator)
            seen_all = seen if seen_all is None else (seen_all | seen)
            k += 1

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        graph = batch["graph"]
        x, x_seen = self._run_branches(0, batch["feats"], batch, None,
                                       generator)
        x = self.stem(x, graph)
        skips = [x]
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x, graph, i)
            x, _ = self._run_branches(i + 1, x, batch, None, generator)
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


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialization, drawn on the CPU so one seed gives the
    same weights on every device: He-normal sparse and 2D conv kernels
    (fan-in), LeCun-normal linear weights, zero biases, unit norm scales,
    and fresh running statistics (the flax initializers' families)."""
    from ..modules.image_encoders import Conv2dWS
    from ..modules.pooling import Gating
    from ..nn.norm import MaskedBatchNorm
    from ..nn.sparse_blocks import SparseConv

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, SparseConv):
            k, cin, _ = m.weight.shape
            normal_(m.weight, float(np.sqrt(2.0 / (k * cin))))
        elif isinstance(m, Conv2dWS):
            normal_(m.weight, float(np.sqrt(2.0 / m.weight[0].numel())))
        elif isinstance(m, nn.Linear):
            normal_(m.weight, float(np.sqrt(1.0 / m.in_features)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (MaskedBatchNorm, nn.GroupNorm, Gating)):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
