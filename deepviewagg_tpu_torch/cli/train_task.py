"""Train a non-segmentation task head: ``python -m
deepviewagg_tpu_torch.cli.train_task --task classification [--root DIR]
[--epochs N] [--batches N] [--batch_size N] [--lr F] [--seed N]
[--device cpu]``.

The port of ``scripts/train_task.py``, on one card unless ``--device cpu``
is given.  Tasks: classification (``SparseConv3dCls``, Res16UNet14, on the
ModelNet layout ``<root>/<class>/train/*.off`` or procedural shapes),
detection (``VoteNetDet`` on ``<root>/scene_*.npz`` box scenes or synthetic
rooms), panoptic (``PanopticSeg``: semantics + instance offsets, on
``<root>/scene_*.npz`` or synthetic rooms) and registration
(``RegistrationNet``, FCGF-style descriptors, on ``<root>/pair_*.npz``
fragment pairs or synthetic ones), each through :class:`TaskTrainer` with
the JAX script's settings.  Prints ``epoch k: ...`` lines and ``final:
{...}``; returns the last epoch's metrics.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.collate import Bucket
from ..data.datasets import tasks as T
from ..train import task_steps as S
from .train import setup_device

__all__ = ["main"]

TASKS = ("classification", "detection", "panoptic", "registration")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", required=True, choices=TASKS)
    parser.add_argument("--root", default=None,
                        help="dataset dir (omit for procedural data)")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = str(setup_device(args.device))

    rng = np.random.default_rng(args.seed)

    if args.task == "classification":
        from ..models.classification import SparseConv3dCls

        ds = T.make_classification_dataset(args.root, train=True)
        bucket = Bucket(level_caps=[2048, 2048, 1024, 512, 256],
                        num_batches=args.batch_size)
        model = SparseConv3dCls(num_classes=ds.num_classes,
                                num_batches=args.batch_size, device=device,
                                seed=None)
        step = S.make_classification_step(model)

        def make_batches():
            for _ in range(args.batches):
                samples = [ds[int(rng.integers(len(ds)))]
                           for _ in range(args.batch_size)]
                yield T.collate_classification(samples, bucket)

    elif args.task == "detection":
        from ..models.detection import VoteNetDet

        ds = T.make_detection_dataset(args.root, train=True)
        model = VoteNetDet(num_classes=ds.num_classes,
                           sa_channels=((16, 32), (32, 64)), device=device,
                           seed=None)
        step = S.make_detection_step(model)

        def make_batches():
            for i in range(args.batches):
                yield ds[i % len(ds)]

    elif args.task == "panoptic":
        from ..models.panoptic import PanopticSeg

        ds = T.make_panoptic_dataset(args.root, train=True, voxel_size=0.15)
        bucket = Bucket(level_caps=[12288, 4096, 2048, 1024, 512],
                        num_batches=args.batch_size)
        model = PanopticSeg(num_classes=ds.num_classes, device=device,
                            seed=None)
        step = S.make_panoptic_step(model, num_instances=64)

        def make_batches():
            for _ in range(args.batches):
                samples = [ds[int(rng.integers(len(ds)))]
                           for _ in range(args.batch_size)]
                yield T.collate_panoptic(samples, bucket)

    else:  # registration
        from ..models.registration import RegistrationNet

        ds = T.make_registration_dataset(args.root, train=True)
        bucket = Bucket(level_caps=[4096, 2048, 1024, 512, 256],
                        num_batches=1)
        model = RegistrationNet(descriptor_dim=16, backbone="Res16UNetTest",
                                device=device, seed=None)
        step = S.make_registration_step(model)

        def make_batches():
            for i in range(args.batches):
                yield T.collate_registration(ds[i % len(ds)], bucket)

    trainer = S.TaskTrainer(model, step, base_lr=args.lr, device=device)
    # the JAX script draws one batch to initialise its model: draw it too,
    # so that the epochs see the same batches
    next(iter(make_batches()))
    trainer.init(seed=args.seed)
    metrics = trainer.fit(make_batches, epochs=args.epochs)
    print("final:", {k: round(float(v), 4) for k, v in metrics.items()},
          flush=True)
    return metrics


if __name__ == "__main__":
    main()
