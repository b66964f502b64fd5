"""Evaluate a checkpoint: ``python -m deepviewagg_tpu_torch.cli.eval
--run_dir runs/x [--device cpu] [k=v ...]``.

The port of the root ``eval.py`` (the reference's ``eval.py``:
conf/eval.yaml -> Trainer.eval(): voting runs, full-resolution tracker
finalise, optional benchmark submission, trainer.py:165-258), on one card
unless ``--device cpu`` is given.  The run dir's ``run.json`` is the base
config; ``--config`` and ``k=v`` overrides refine it.  ``--voting_runs N``
repeats the eval pass, runs after the first with MC dropout, accumulating
logits per original point id; ``--full_res`` remaps the votes onto the raw
cloud by 1-NN; ``--submission <dir>`` turns the votes on and writes the
benchmark files there: for ScanNet one ``<scan>.txt`` per cache (its stem)
of NYU40 ids, for KITTI-360 ``submission.zip`` of one
``<seq>_<start>_<end>.npy`` of original label ids per window, both at voxel
level (neither cache keeps a raw cloud, so there is nothing to remap).  A
``no3d`` model's unseen points take the logits of their nearest seen point
before they are tracked and voted (``propagate_unseen``, the JAX CLI's
eval.py:103-110).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config.run import load_run_config
from ..config.zoo import resolve_spec_from_cfg
from ..data.collate import batch_to_torch, device_view
from ..data.datasets.base import BatchLoader, load_area
from ..metrics.tracker import SegmentationTracker, VoteAccumulator
from ..models.losses import propagate_unseen
from ..models.segmentation import No3DSeg, build_model
from ..train.checkpoint import CheckpointManager
from ..train.step import make_eval_step
from .train import auto_bucket, build_dataset, setup_device

__all__ = ["main", "vote"]


def vote(model, loader, voting_runs: int, device, tracker, votes=None,
         cloud_size=None) -> None:
    """The voting loop: ``voting_runs`` passes over ``loader``, the first
    through the model's eval step (tracked by ``tracker``), the others with
    MC dropout (a no-op unless the model's spec has ``head_dropout`` > 0);
    with ``votes``, every pass adds each sample's logits under its original
    point ids (``cloud_size(cloud)``: the cloud's point count).  A
    ``No3DSeg``'s unseen points (and padding rows) take the logits of their
    nearest seen valid point first."""
    no3d = isinstance(model, No3DSeg)
    eval_step = make_eval_step(model)
    mc_step = make_eval_step(model, mc_dropout=True)
    # one generator on the model's device for every batch of the MC runs,
    # seeded from 0 as the JAX CLI splits one PRNGKey(0) per batch (the
    # streams differ)
    generator = torch.Generator(device=device).manual_seed(0)
    for run in range(voting_runs):
        t0, n_batches = time.perf_counter(), 0
        for batch in loader:
            dev_batch = batch_to_torch(device_view(batch), device)
            if run > 0:
                out = mc_step(None, dev_batch, generator)
            else:
                out = eval_step(None, dev_batch)
            valid = np.asarray(batch["graph"]["levels"][0]["valid"])
            if no3d and "x_seen" in out and "pos" in dev_batch:
                # the reference's No3D eval semantics (no3d.py:105-126)
                seen = out["x_seen"] & dev_batch["graph"]["levels"][0]["valid"]
                out["logits"] = propagate_unseen(out["logits"],
                                                 dev_batch["pos"], seen)
                out["preds"] = out["logits"].argmax(dim=-1)
            preds = out["preds"].cpu().numpy()
            logits = out["logits"].cpu().numpy()
            n_batches += 1
            if run == 0:
                tracker.track(preds, batch["labels"], valid)
            if votes is not None:
                # per-sample vote accumulation keyed by original point ids
                start = 0
                meta = batch["meta"]
                for cloud, ids, size in zip(
                    meta["clouds"], meta["origin_ids"], meta["sizes"]
                ):
                    if cloud is None or ids is None:
                        start += size
                        continue
                    votes.add(cloud, cloud_size(cloud), ids,
                              logits[start:start + size])
                    start += size
        print(f"voting run {run}: {n_batches} batches in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.eval")
    parser.add_argument("--config", default=None)
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--weight", default="latest",
                        help="latest or best_<metric>")
    parser.add_argument("--voting_runs", type=int, default=1)
    parser.add_argument("--full_res", action="store_true")
    parser.add_argument("--submission", default=None,
                        help="write a benchmark submission to this dir "
                             "(ScanNet or KITTI-360)")
    parser.add_argument("--vote_ram_budget_mb", type=int, default=4096,
                        help="RAM cap for vote arrays; clouds past it spill "
                             "to memmap'd files (ref kitti360_tracker "
                             "tempdir votes)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    parser.add_argument("overrides", nargs="*")
    # options may stand between or after the overrides
    args = parser.parse_intermixed_args(argv)
    device = setup_device(args.device)

    # the stored training config is the source of truth for model/data
    # shapes; --config and CLI overrides refine it (ref trainer.py:84)
    stored = None
    run_json = os.path.join(args.run_dir, "run.json")
    if os.path.exists(run_json):
        with open(run_json) as f:
            stored = json.load(f)
        print(f"restored run config from {run_json}")
    cfg = load_run_config(args.config, args.overrides, base=stored)
    val_ds = build_dataset(cfg, train=False, device=device)
    num_classes = getattr(val_ds, "num_classes", cfg.data.num_classes)
    spec = resolve_spec_from_cfg(cfg.model, num_classes)
    branch_levels = sorted(dict(spec.branches))
    bucket = auto_bucket(cfg, val_ds, branch_levels)
    # params-only restore: eval needs no optimizer state
    model = CheckpointManager(args.run_dir).restore_variables(
        args.weight, build_model(spec, device=device, seed=None))
    loader = BatchLoader(val_ds, bucket, cfg.data.batch_size, branch_levels,
                         shuffle=False, conv0_kernel=spec.stem_kernel)

    tracker = SegmentationTracker(num_classes, "test")
    do_votes = args.voting_runs > 1 or args.full_res or args.submission
    votes = VoteAccumulator(
        num_classes, ram_budget_bytes=args.vote_ram_budget_mb << 20
    ) if do_votes else None
    cloud_sizes = {}   # avoid re-loading whole areas per sample

    def cloud_size(cloud):
        if cloud not in cloud_sizes:
            cloud_sizes[cloud] = len(load_area(cloud)["pos"])
        return cloud_sizes[cloud]

    vote(model, loader, args.voting_runs, device, tracker, votes, cloud_size)
    metrics = tracker.get_metrics()

    if votes is not None:
        vote_tracker = SegmentationTracker(num_classes, "vote")
        full_tracker = SegmentationTracker(num_classes, "full_res")
        any_full = False
        window_preds = {}
        for cloud in votes.clouds():
            area = load_area(cloud)
            preds, mask = votes.preds(cloud)
            if "labels" in area:
                vote_tracker.track(preds[mask], area["labels"][mask])
            name = os.path.splitext(os.path.basename(cloud))[0]
            window_preds[name] = preds
            if args.full_res and "raw_pos" in area:
                # 1-NN remap of votes onto the raw cloud
                t0 = time.perf_counter()
                full = votes.full_res_preds(cloud, area["pos"],
                                            area["raw_pos"], device=device)
                print(f"full_res remap {os.path.basename(cloud)}: "
                      f"{len(area['raw_pos'])} raw points onto "
                      f"{int(mask.sum())} voted in "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
                window_preds[name] = full
                if "raw_labels" in area:
                    full_tracker.track(full, area["raw_labels"])
                    any_full = True
        metrics.update(vote_tracker.get_metrics())
        if any_full:
            metrics.update(full_tracker.get_metrics())
        if args.submission and cfg.data.dataset == "kitti360":
            from ..data.datasets.kitti360 import write_submission

            print("submission:", write_submission(args.submission,
                                                  window_preds))
        elif args.submission and cfg.data.dataset == "scannet":
            from ..data.datasets.scannet import write_submission

            print("submission:", write_submission(args.submission,
                                                  window_preds))
    print(json.dumps({k: round(v, 3) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
