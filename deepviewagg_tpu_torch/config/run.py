"""Run configuration: YAML + CLI overrides (the Hydra-compose role).

The port of ``deepviewagg_tpu/config/run.py``: the same dataclass tree, the
same merge and override rules.  YAML is read by :mod:`.yaml_subset` (the
card's machine has no PyYAML), for the files and for the override values
alike.  ``base=`` merges a stored run config first (a run dir's
``run.json``, for eval and predict):

    python -m deepviewagg_tpu_torch.cli.train --config conf/synthetic.yaml \\
        training.epochs=10 'data.kwargs={n_areas: 2}'
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .yaml_subset import safe_load

__all__ = ["RunConfig", "load_run_config", "apply_overrides"]


@dataclasses.dataclass
class ModelCfg:
    name: str = "Res16UNet34-L4-early-ade20k-interpolate"
    in_channels: int = 4
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # path to a torch ResNet18 checkpoint (ADE20K/Cityscapes/ImageNet) to
    # overlay on every image branch at init (utils/pretrained.py); implies
    # tower_norm='batch' on the branches
    tower_weights: Optional[str] = None
    tower_frozen: bool = False        # ref modalities/image.py:737 'frozen'


@dataclasses.dataclass
class DataCfg:
    dataset: str = "synthetic"
    # ingest a published reference data YAML verbatim (e.g.
    # ref=s3disfused-sparse): its resolution / credits / transform-chain
    # parameters are merged into this section before CLI overrides
    # (config/reference_ingest.load_data_cfg)
    ref: Optional[str] = None
    root: str = "/tmp/dva_data"
    voxel_size: float = 0.05
    radius: float = 2.0
    image_slots: int = 4
    # the reference evaluates under its own pixel budget (test_pixel_credit,
    # s3disfused-sparse.yaml:109); None = same as image_slots
    eval_image_slots: Optional[int] = None
    samples_per_epoch: int = 2000
    batch_size: int = 4
    num_classes: int = 4
    # bucket capacities (0 = auto-measure from a probe epoch)
    level_caps: List[int] = dataclasses.field(default_factory=list)
    view_cap: int = 0
    pix_cap: int = 0
    image_cap: int = 0
    image_size: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    # crop-group families: min ladder size enables Bucket.image_ladder
    crop_ladder_min: int = 0
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainingCfg:
    epochs: int = 100
    base_lr: float = 0.1
    lr_schedule: str = "multi_step"
    lr_milestones: List[int] = dataclasses.field(default_factory=list)
    lr_gamma: float = 0.3
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: Optional[float] = 10.0
    grad_accumulate: int = 1
    lovasz_weight: float = 0.0
    # view-level loss weight (no3d.py:139-155; needs a no3d model)
    view_loss_weight: float = 0.0
    eval_frequency: int = 1
    data_parallel: bool = False
    # shard the 2D towers' image axis over this many devices per data shard
    view_parallel: int = 1
    run_dir: Optional[str] = None
    resume: bool = False
    seed: int = 0
    num_batches_cap: Optional[int] = None     # debugging.num_batches
    early_break: bool = False                 # debugging.early_break
    # observability fan-out (ref utils/wandb_utils.py:30, base_tracker.py:80)
    tensorboard: bool = True
    wandb: bool = False
    wandb_project: Optional[str] = None


@dataclasses.dataclass
class RunConfig:
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    training: TrainingCfg = dataclasses.field(default_factory=TrainingCfg)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _merge(dc, data: Dict):
    for k, v in (data or {}).items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {type(dc).__name__}.{k}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            setattr(dc, k, v)


def apply_overrides(cfg: RunConfig, overrides: List[str]) -> RunConfig:
    """``section.key=value`` CLI overrides with YAML-parsed values."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        path, raw = ov.split("=", 1)
        value = safe_load(raw)
        node: Any = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            node = getattr(node, p) if dataclasses.is_dataclass(node) else node[p]
        last = parts[-1]
        if dataclasses.is_dataclass(node):
            if not hasattr(node, last):
                raise KeyError(f"unknown config key: {path}")
            setattr(node, last, value)
        else:
            node[last] = value
    return cfg


def load_run_config(path: Optional[str] = None,
                    overrides: Optional[List[str]] = None,
                    base: Optional[Dict] = None) -> RunConfig:
    """The defaults, then ``base``, then the YAML file at ``path``, then
    ``overrides``.

    ``base``: a stored run-config dict (a run dir's ``run.json``) merged
    first, so that evaluating a saved run reproduces its training config
    unless the YAML or the CLI override it (ref trainer.py:84,
    model_checkpoint.py:241-253).  Two branches of the JAX function are
    left out: it skips stored keys that its schema lacks, and it migrates a
    stored config without ``stem_kernel`` to the old kernel-5 stem.  Every
    ``run.json`` the port reads is one it wrote from this schema, with
    ``stem_kernel`` pinned (``cli/train.py``, ``CheckpointManager``), and
    the port cannot read a JAX checkpoint; so an unknown stored key
    raises, as it does in a YAML file."""
    cfg = RunConfig()
    if base:
        _merge(cfg, base)
    if path:
        with open(path) as f:
            _merge(cfg, safe_load(f.read()) or {})
    cfg = apply_overrides(cfg, overrides or [])
    if cfg.data.ref:
        _apply_data_ref(cfg)
        # CLI overrides win over the ingested values too
        cfg = apply_overrides(cfg, [o for o in (overrides or [])
                                    if o.split("=", 1)[0].startswith("data.")])
    return cfg


def _apply_data_ref(cfg: RunConfig) -> None:
    """``data.ref`` ingests a published reference data YAML in the JAX
    package; the ingest is not ported."""
    raise NotImplementedError(
        f"data.ref={cfg.data.ref!r}: reference data-YAML ingest is not ported "
        "yet (ROADMAP A.2.3)")
