"""A configuration file turned into the port's objects: its run config,
dataset, bucket, model with seeded weights, and training object.

Everything goes through the port's own entry points (``cli.train``'s
``build_dataset`` and ``auto_bucket``, the zoo, ``build_model``,
``Trainer``); nothing here computes what the program computes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .weights import seeded_state

__all__ = ["run_config", "build_model", "trainer_config", "RecordingDataset",
           "batch_coords", "hyper", "bucket", "cell_data"]


def run_config(cfg: Dict, root: str, seed: int, dataset: str,
               data_kwargs: Optional[Dict] = None):
    """The port's ``RunConfig`` of a configuration file."""
    from deepviewagg_tpu_torch.config.run import RunConfig

    rc = RunConfig()
    rc.model.name = cfg["model"]["name"]
    rc.model.in_channels = cfg["model"]["in_channels"]
    rc.model.overrides = dict(cfg["model"].get("overrides", {}))
    d = cfg["data"]
    rc.data.dataset = dataset
    rc.data.root = root
    for key in ("voxel_size", "radius", "image_slots", "samples_per_epoch",
                "batch_size", "image_size"):
        setattr(rc.data, key, d[key])
    rc.data.num_classes = cfg["model"]["num_classes"]
    rc.data.kwargs = dict(data_kwargs or {})
    for key, value in cfg["training"].items():
        setattr(rc.training, key, value)
    rc.training.seed = int(seed)
    rc.training.run_dir = None
    rc.training.tensorboard = False
    return rc


def cell_data(cfg: Dict, params: Dict, workdir: str, device,
              train: bool = True):
    """``(run config, dataset, bucket)`` of a cell's data, made from its
    ``data_seed``: the port's synthetic areas under ``workdir``
    (``dataset: synthetic``, through ``cli.train``'s ``build_dataset``) or
    a synthetic street held in memory (``dataset: street``)."""
    from deepviewagg_tpu_torch.cli.train import build_dataset

    seed = params["data_seed"]
    if params["dataset"] == "street":
        from .street import street_dataset

        rc = run_config(cfg, workdir, seed, "kitti360")
        ds = street_dataset(cfg, params["street"], seed, device, train)
    else:
        kwargs = dict(params["scene"], seed=seed,
                      aug_params=dict(cfg["data"]["augment"]))
        rc = run_config(cfg, workdir + "/areas", seed, params["dataset"],
                        kwargs)
        ds = build_dataset(rc, train=train, device=device)
    return rc, ds, bucket(rc, ds, params["bucket"])


def bucket(rc, dataset, pins: Dict):
    """The batches' static capacities, pinned by the cell (every seed then
    runs the same shapes): through ``cli.train``'s ``auto_bucket`` for a
    flat image batch, or as a camera-family bucket where the dataset has
    families."""
    from deepviewagg_tpu_torch.cli.train import auto_bucket
    from deepviewagg_tpu_torch.data.collate import Bucket

    families = getattr(dataset, "image_families", None)
    if not families:
        rc.data.level_caps = list(pins["level_caps"])
        for key in ("view_cap", "pix_cap", "image_cap"):
            setattr(rc.data, key, pins[key])
        return auto_bucket(rc, dataset, [0])
    return Bucket(level_caps=list(pins["level_caps"]),
                  num_batches=rc.data.batch_size, view_cap=pins["view_cap"],
                  pix_cap=pins["pix_cap"], image_cap=pins["image_cap"],
                  image_size=tuple(rc.data.image_size),
                  image_ladder=[tuple(f) for f in families],
                  ladder_image_caps=list(pins["ladder_image_caps"]),
                  ladder_pix_caps=list(pins["ladder_pix_caps"]))


def hyper(cfg: Dict) -> Dict:
    """The optimizer's settings, for the reference."""
    t = cfg["training"]
    return {k: t[k] for k in ("base_lr", "lr_gamma", "lr_milestones",
                              "momentum", "weight_decay", "grad_clip")}


def build_model(rc, num_classes: int, seed: int, device):
    """``(spec, model, initial state)``: the configuration's model on
    ``device`` with weights drawn from ``seed`` there."""
    from deepviewagg_tpu_torch.config.zoo import resolve_spec_from_cfg
    from deepviewagg_tpu_torch.models.segmentation import build_model as bm

    spec = resolve_spec_from_cfg(rc.model, num_classes)
    model = bm(spec, device=device, seed=None)
    return spec, model, seeded_state(model, seed)


def trainer_config(rc):
    """The ``TrainerConfig`` that ``cli.train`` builds from ``rc``."""
    from deepviewagg_tpu_torch.train.trainer import TrainerConfig

    t = rc.training
    return TrainerConfig(
        epochs=1, eval_frequency=1, lovasz_weight=t.lovasz_weight,
        base_lr=t.base_lr, lr_schedule=t.lr_schedule,
        lr_milestones=tuple(t.lr_milestones), lr_gamma=t.lr_gamma,
        optimizer=t.optimizer, momentum=t.momentum,
        weight_decay=t.weight_decay, grad_clip=t.grad_clip,
        run_dir=None, tensorboard=False)


class RecordingDataset:
    """The dataset as the loader sees it, keeping the voxel coordinates of
    each sample it hands out (in order) for the reference and the FLOP
    count; a sample the loader would have to split is refused, since the
    batch's rows would then no longer follow its samples."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.coords: List[np.ndarray] = []

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __getitem__(self, idx):
        s = self.dataset[idx]
        if s is not None:
            self.coords.append(np.asarray(s.coords, np.int32))
        return s

    def take(self, batch) -> np.ndarray:
        """The ``[n, 4]`` (sample, x, y, z) coordinates of the next batch
        the loader yielded."""
        sizes = batch["meta"]["sizes"]
        parts = [self.coords.pop(0) for _ in sizes]
        if [len(p) for p in parts] != list(sizes):
            raise RuntimeError("the loader split a sample; its batch rows "
                               "no longer follow the samples")
        return batch_coords(parts)


def batch_coords(parts) -> np.ndarray:
    return np.concatenate([
        np.concatenate([np.full((len(c), 1), b, np.int32), c], 1)
        for b, c in enumerate(parts)])
