"""Train a model: ``python -m deepviewagg_tpu_torch.cli.train --config
conf/x.yaml [--device cpu] [k=v ...]``.

The port of the root ``train.py`` (the reference's ``train.py``: Hydra @main
-> Trainer(cfg).train()), on one card unless ``--device cpu`` is given:

    python -m deepviewagg_tpu_torch.cli.train --config conf/synthetic.yaml \\
        training.epochs=5 model.name=Res16UNet34-L4-early

Config groups (``deepviewagg_tpu_torch/config/run.py``): model / data /
training.  ``training.resume=true`` restores the run dir's ``latest``
checkpoint before training.  The synthetic, S3DIS, ScanNet and KITTI-360
datasets are ported:

    python -m deepviewagg_tpu_torch.cli.train \
        --config conf/s3dis_benchmark.yaml data.root=<2D-3D-S layout>
    python -m deepviewagg_tpu_torch.cli.train \
        --config conf/scannet_benchmark.yaml data.root=<ScanNet layout>
    python -m deepviewagg_tpu_torch.cli.train \
        --config conf/kitti360_benchmark.yaml data.root=<KITTI-360 layout>

``model.tower_weights=<.pth>`` loads a torchvision or MIT-semseg ResNet18
checkpoint into every image branch's tower (BatchNorm towers, the stem read
from the checkpoint and pinned into the stored config as
``model.overrides.tower_deep_stem``); ``model.tower_frozen=true`` keeps the
towers out of the optimizer and runs them in eval mode.

``training.data_parallel=true`` trains on every card of the host, one
process per card (NCCL), each on its own batches; under torchrun (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) each process joins that group instead, on the card of its
``LOCAL_RANK`` or, with ``--device cpu``, over gloo; with ``--device cpu``
and no such launcher it is a world of one, as on a host with one card; a
caller that has brought up the default process group itself keeps it.
``training.view_parallel=m`` also splits each batch's images over groups of
``m`` processes (GroupNorm towers only)::

    torchrun --nproc_per_node 4 -m deepviewagg_tpu_torch.cli.train \
        --config conf/synthetic.yaml training.data_parallel=true \
        training.view_parallel=2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config.run import load_run_config
from ..config.zoo import recipe_lr_keywords, resolve_spec_from_cfg
from ..data.collate import Bucket
from ..data.datasets.base import BatchLoader
from ..models.segmentation import build_model
from ..ops import voxel as _voxel
from ..parallel import multihost
from ..train.trainer import Trainer, TrainerConfig
from ..utils import pretrained

__all__ = ["setup_device", "build_dataset", "auto_bucket", "shard_batches",
           "main"]


def setup_device(name: str) -> torch.device:
    """The entry points' device: ``name`` (``cuda`` unless the caller asks
    for ``cpu``); raises where CUDA is asked for and absent.  Pins TF32 off
    for float32 matmuls and cuDNN convolutions (PyTorch leaves the cuDNN
    one on), so that a run computes what ``chip_smoke.py`` checks and the
    sparse convs' float32 GEMMs stay float32, and prints both flags."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {device} allow_tf32_matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} allow_tf32_cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return device


def build_dataset(cfg, train: bool, device="cuda"):
    """The train or eval dataset of a run config; the cache is preprocessed
    on ``device``."""
    # the reference evaluates under its own pixel budget
    # (test_pixel_credit -> data.eval_image_slots)
    if not train and cfg.data.eval_image_slots:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, image_slots=cfg.data.eval_image_slots))
    if cfg.data.dataset == "synthetic":
        from ..data.datasets.synthetic_ds import make_synthetic_dataset

        return make_synthetic_dataset(
            cfg.data.root, train=train, radius=cfg.data.radius,
            voxel_size=cfg.data.voxel_size, image_slots=cfg.data.image_slots,
            samples_per_epoch=cfg.data.samples_per_epoch,
            image_size=tuple(cfg.data.image_size), device=device,
            **cfg.data.kwargs,
        )
    if cfg.data.dataset == "s3dis":
        from ..data.datasets.s3dis import make_s3dis_dataset

        # no image_size: the preprocess runs at its own 1024 x 512, as the
        # JAX CLI's does
        return make_s3dis_dataset(
            cfg.data.root, train=train, radius=cfg.data.radius,
            voxel_size=cfg.data.voxel_size, image_slots=cfg.data.image_slots,
            samples_per_epoch=cfg.data.samples_per_epoch, device=device,
            **cfg.data.kwargs,
        )
    if cfg.data.dataset == "scannet":
        from ..data.datasets.scannet import make_scannet_dataset

        # the JAX CLI's arguments exactly: no radius, samples_per_epoch or
        # image_size; the YAML's values for those reach the loader only
        # through data.kwargs
        return make_scannet_dataset(
            cfg.data.root, train=train, voxel_size=cfg.data.voxel_size,
            image_slots=cfg.data.image_slots, device=device,
            **cfg.data.kwargs,
        )
    if cfg.data.dataset == "kitti360":
        from ..data.datasets.kitti360 import make_kitti360_dataset

        # the JAX CLI's arguments exactly: radius and samples_per_epoch
        # from data.*, the image sizes from data.kwargs (the loader's
        # defaults are the recipe's 704 x 188 and 350 x 350)
        return make_kitti360_dataset(
            cfg.data.root, train=train, radius=cfg.data.radius,
            voxel_size=cfg.data.voxel_size, image_slots=cfg.data.image_slots,
            samples_per_epoch=cfg.data.samples_per_epoch, device=device,
            **cfg.data.kwargs,
        )
    raise KeyError(cfg.data.dataset)


def auto_bucket(cfg, dataset, branch_levels, probe: int = 8):
    """Measure capacities from a few samples when not pinned in config."""
    if cfg.data.level_caps:
        return Bucket(
            level_caps=list(cfg.data.level_caps),
            num_batches=cfg.data.batch_size,
            view_cap=cfg.data.view_cap, pix_cap=cfg.data.pix_cap,
            image_cap=cfg.data.image_cap,
            image_size=tuple(cfg.data.image_size),
        )
    views, pix = [], []
    bucket_pix = None      # per-ladder-bucket pixel/image maxima
    bucket_imgs = None
    ladder = None
    family_ladder = getattr(dataset, "image_families", None)
    if family_ladder:
        # camera-family buckets at native aspect (KITTI-360 pinhole +
        # fisheye)
        ladder = [tuple(s_) for s_ in family_ladder]
        bucket_pix = [0] * len(ladder)
        bucket_imgs = [0] * len(ladder)
    elif cfg.data.crop_ladder_min > 0:
        from ..data.crop_groups import crop_ladder

        ladder = crop_ladder(tuple(cfg.data.image_size),
                             min_size=cfg.data.crop_ladder_min)
        bucket_pix = [0] * len(ladder)
        bucket_imgs = [0] * len(ladder)
    counts_levels = None
    rng = np.random.default_rng(0)
    for _ in range(probe):
        s = dataset[int(rng.integers(len(dataset)))]
        if s is None:
            continue
        if s.mapping is not None:
            views.append(s.mapping.num_views)
            pix.append(s.mapping.num_pixels)
            if ladder is not None and s.images is not None:
                from ..data.crop_groups import (assign_crop_groups,
                                                split_mapping_by_bucket)

                if family_ladder and s.image_family is not None:
                    # each image's bucket is its camera family, at native
                    # size from the canvas origin
                    ass = {
                        "mapping": s.mapping, "images": s.images,
                        "image_bucket": np.asarray(s.image_family, np.int64),
                        "crop_origin": np.zeros(
                            (len(s.image_family), 2), np.int64),
                    }
                else:
                    ass = assign_crop_groups(
                        {"mapping": s.mapping, "images": s.images}, ladder
                    )
                mmp = split_mapping_by_bucket(ass, ladder,
                                              include_images=False)
                for bi, bk in enumerate(mmp["buckets"]):
                    bucket_pix[bi] = max(bucket_pix[bi], len(bk["pix_view"]))
                    bucket_imgs[bi] = max(
                        bucket_imgs[bi],
                        int((ass["image_bucket"] == bi).sum()),
                    )
        coords = np.concatenate(
            [np.zeros((len(s.coords), 1), np.int32), s.coords], axis=1
        )
        cur, stride, counts = coords, 1, [len(coords)]
        for _ in range(4):
            cur, _ = _voxel.downsample_coords(cur, stride * 2)
            stride *= 2
            counts.append(len(cur))
        counts = np.array(counts)
        counts_levels = counts if counts_levels is None else np.maximum(
            counts_levels, counts
        )
    b = cfg.data.batch_size
    margin = 1.3

    def cap(x, m=256):
        return int(-(-int(x * margin) // m) * m)

    ladder_icaps = None
    ladder_qcaps = None
    if ladder is not None and views:
        # measured per-bucket maxima from the probe; per-bucket distribution
        # varies a lot between samples, so use a generous margin (the
        # BatchLoader only enforces the GLOBAL pixel cap when grouping)
        ladder_icaps = [
            max(1, min(int(m * b) + 2, b * cfg.data.image_slots))
            for m in bucket_imgs
        ]
        ladder_qcaps = [max(cap(m * b * 2.5), 512) for m in bucket_pix]

    return Bucket(
        level_caps=[cap(c * b) for c in counts_levels],
        num_batches=b,
        view_cap=cap(max(views) * b) if views else 0,
        pix_cap=cap(max(pix) * b) if pix else 0,
        image_cap=b * cfg.data.image_slots,
        image_size=tuple(cfg.data.image_size),
        image_ladder=ladder,
        ladder_image_caps=ladder_icaps,
        ladder_pix_caps=ladder_qcaps,
    )


def shard_batches(batches, n_data: int, data_rank: int):
    """The data-parallel contract (the JAX CLI's ``chunk_per_device``):
    each step consumes one batch per data shard, so this rank takes the
    batches ``i`` with ``i % n_data == data_rank``; the trailing
    ``len % n_data`` batches are dropped on every rank (repeating batches
    would give duplicated samples double gradient weight)."""
    mine, seen = None, 0
    for i, batch in enumerate(batches):
        seen = i + 1
        if i % n_data == data_rank:
            mine = batch
        if i % n_data == n_data - 1:
            yield mine
            mine = None
    left = seen % n_data
    if left and seen < n_data:
        # an epoch smaller than the data shards would silently train ZERO
        # steps under drop_last: a config error, not a remainder
        raise ValueError(
            f"data_parallel epoch produced {left} batch(es) for {n_data} "
            f"devices — raise data.samples_per_epoch or shrink the mesh")
    if left and multihost.is_primary():
        print(f"data_parallel: dropped {left} trailing batch(es) short of "
              f"the {n_data}-device step")


def _rank_main(rank: int, argv, world: int, port: int, out) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    metrics = main(argv)
    if rank == 0:
        out.put(metrics)      # a few floats: fits the pipe, never blocks


def _spawn_per_card(argv, world: int):
    """One process per card of this host, each running :func:`main` in a
    torchrun-style group; a process that fails ends the others and raises
    here.  Returns rank 0's metrics."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank_main, args=(argv, world, port, out),
                               nprocs=world, join=False,
                               start_method="spawn")
    while not ranks.join():
        pass
    return out.get()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.train")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    parser.add_argument("overrides", nargs="*")
    # options may stand between or after the overrides
    args = parser.parse_intermixed_args(argv)
    cfg = load_run_config(args.config, args.overrides)
    name = args.device
    # a caller that brought the process group up keeps it (and its device)
    if (cfg.training.data_parallel and torch.device(name).type == "cuda"
            and not dist.is_initialized()):
        if multihost.torchrun_env():
            name = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
        elif torch.cuda.device_count() > 1:
            # make_mesh() takes every device, as the JAX package's does
            return _spawn_per_card(
                sys.argv[1:] if argv is None else list(argv),
                torch.cuda.device_count())
    device = setup_device(name)
    started = cfg.training.data_parallel and multihost.initialize(
        device=device)
    try:
        return _train(cfg, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(cfg, device):
    # the first process writes the caches, the others read them
    with (multihost.primary_first() if cfg.training.data_parallel
          else contextlib.nullcontext()):
        train_ds = build_dataset(cfg, train=True, device=device)
        val_ds = build_dataset(cfg, train=False, device=device)
    num_classes = getattr(train_ds, "num_classes", cfg.data.num_classes)

    spec = resolve_spec_from_cfg(cfg.model, num_classes)
    if cfg.training.view_parallel > 1 and any(
            b.tower_norm == "batch" for _, b in spec.branches):
        # a tower BatchNorm computes per-shard statistics (and would
        # include zero-pad images), silently diverging from the unsharded
        # model: only GroupNorm towers shard exactly
        raise ValueError(
            "training.view_parallel requires GroupNorm towers "
            "(tower_norm='group'); BatchNorm statistics are per-model-shard "
            "under view sharding")
    freeze_paths = None
    if cfg.model.tower_frozen:
        freeze_paths = pretrained.freeze_paths_for_spec(spec)
    if cfg.model.tower_weights and spec.branches:
        # the stem was sniffed from the checkpoint: pin it, so that a
        # restore never needs the checkpoint file again
        cfg.model.overrides.setdefault(
            "tower_deep_stem", spec.branches[0][1].tower_deep_stem)
    branch_levels = sorted(dict(spec.branches))
    bucket = auto_bucket(cfg, train_ds, branch_levels)
    graph = spec.family if spec.family in ("ptv3", "ptv2") else "unet"
    if graph != "unet":
        bucket = dataclasses.replace(bucket, view_cap=0, pix_cap=0,
                                     image_cap=0)
    print(f"bucket: levels={list(bucket.level_caps)} views={bucket.view_cap} "
          f"pix={bucket.pix_cap} imgs={bucket.image_cap}")

    model = build_model(spec, device=device, seed=cfg.training.seed)
    if cfg.model.tower_weights:
        loaded = pretrained.apply_tower_weights(model, spec,
                                                cfg.model.tower_weights)
        print("loaded tower weights:", loaded, flush=True)
        if not loaded or not all(loaded.values()):
            raise ValueError(f"{cfg.model.tower_weights}: no parameter "
                             f"loaded into a tower ({loaded})")
    train_loader = BatchLoader(
        train_ds, bucket, cfg.data.batch_size, branch_levels, shuffle=True,
        seed=cfg.training.seed, conv0_kernel=spec.stem_kernel, graph=graph,
    )
    val_loader = BatchLoader(
        val_ds, bucket, cfg.data.batch_size, branch_levels, shuffle=False,
        conv0_kernel=spec.stem_kernel, graph=graph,
    )
    tcfg = TrainerConfig(
        epochs=cfg.training.epochs,
        eval_frequency=cfg.training.eval_frequency,
        lovasz_weight=cfg.training.lovasz_weight,
        view_loss_weight=cfg.training.view_loss_weight,
        base_lr=cfg.training.base_lr,
        lr_schedule=cfg.training.lr_schedule,
        lr_milestones=tuple(cfg.training.lr_milestones),
        lr_gamma=cfg.training.lr_gamma,
        optimizer=cfg.training.optimizer,
        momentum=cfg.training.momentum,
        weight_decay=cfg.training.weight_decay,
        grad_clip=cfg.training.grad_clip,
        grad_accumulate=cfg.training.grad_accumulate,
        lr_keywords=recipe_lr_keywords(cfg.model.name, cfg.model.overrides),
        freeze_paths=freeze_paths,
        run_dir=cfg.training.run_dir,
        num_batches_cap=cfg.training.num_batches_cap
        if not cfg.training.early_break else 2,
        data_parallel=cfg.training.data_parallel,
        view_parallel=cfg.training.view_parallel,
        tensorboard=cfg.training.tensorboard,
        wandb=cfg.training.wandb,
        wandb_project=cfg.training.wandb_project,
    )
    if cfg.training.lr_schedule == "one_cycle":
        # the cycle spans the run: epochs x the batches of an epoch
        tcfg.total_steps = cfg.training.epochs * -(
            -len(train_ds) // cfg.data.batch_size)
    # pin the resolved stem kernel into the stored run config so restoring
    # this checkpoint can never rebuild a different stem shape
    cfg.model.overrides.setdefault("stem_kernel", spec.stem_kernel)
    trainer = Trainer(model, num_classes, tcfg, seed=cfg.training.seed,
                      run_config=cfg.to_dict())
    if cfg.training.resume and trainer.checkpoint and trainer.checkpoint.has("latest"):
        trainer.state = trainer.checkpoint.restore_state("latest", trainer.state)
        print("resumed from latest checkpoint")
    if trainer.mesh is not None:
        mesh = trainer.mesh
        make_train = lambda: shard_batches(  # noqa: E731
            iter(train_loader), mesh.n_data, mesh.data_rank)
    else:
        make_train = lambda: iter(train_loader)  # noqa: E731
    # eval runs the val loader unchunked on every rank, so every eval
    # sphere is scored once, as by a plain run
    metrics = trainer.fit(make_train, lambda: iter(val_loader))
    print("final:", {k: round(v, 3) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
