"""A copy of the benchmark's description at a size the CPU holds: the same
cells, traffic kinds and metric readers, with small models, images and
scenes; the towers' activations in float32 (this CPU's bfloat16
convolutions are not trusted)."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

S3DIS = "s3dis-res16unet34-l4-early"
KITTI = "kitti360-res16unet34-pointpyramid-early"
# limits for the tiny sizes: the update and gradient norms of a UNet this
# narrow swing with the atomic maximum's routing (a few voxels a norm at
# its coarsest level), the loss does not
TRAIN_LIMITS = {"loss_gap_first": 0.01, "logit_rms_first": 0.05,
                "loss_own_gap": 1e-4, "grad_gap_part": 0.3,
                "update_gap_part": 0.3}
EVAL_LIMITS = {"logit_rms_rel": 1.0, "vote_err": 0.0}


def write(dest: str) -> str:
    """A tiny benchmark directory under ``dest``; returns its path."""
    d = os.path.join(dest, "benchmark")
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(d, "metrics"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for name, model, data in (
            (S3DIS, "Res16UNet14-L1-early-group2-interpolate",
             dict(voxel_size=0.15, radius=1.5, image_slots=2, batch_size=2,
                  image_size=[64, 32])),
            (KITTI, "Res16UNet34-PointPyramid-early-cityscapes-interpolate",
             dict(voxel_size=0.25, radius=4.0, image_slots=2, batch_size=2,
                  image_size=[176, 47], fisheye_size=[70, 70]))):
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            cfg = json.load(f)
        cfg["model"]["name"] = model
        cfg["model"]["overrides"] = {"backbone": "Res16UNetTest",
                                     "tower_bf16": False}
        if name == S3DIS:
            cfg["model"]["num_groups"] = 2
            cfg["model"]["num_classes"] = 5
        cfg["data"].update(data)
        # the port's towers run in float32 here (tower_bf16 off)
        cfg["precision"]["stated"] = {"tower": "f32", "sparse": "bf16"}
        with open(os.path.join(d, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
    for cell in os.listdir(os.path.join(BENCH, "workloads")):
        with open(os.path.join(BENCH, "workloads", cell)) as f:
            w = json.load(f)
        if "scene" in w:
            w["scene"] = {"n_areas": 1, "density": 30.0, "n_cameras": 2}
        if "street" in w:
            w["street"].update(density=20.0, frames=40, max_images=8,
                               nbf_k=10)
        w["limits"] = dict(EVAL_LIMITS if "check_batches" in w
                           else TRAIN_LIMITS)
        with open(os.path.join(d, "workloads", cell), "w") as f:
            json.dump(w, f)
    return d


def execute(bench_dir: str, cell: str, seed: int = 12345678901,
            seconds: float = 1.0):
    """One untraced run of ``cell`` on the CPU: ``(run, checks)``."""
    import time

    import torch

    from benchmark import run as R
    from deepviewagg_tpu_torch.modules.image_encoders import f32_convs

    torch.set_num_threads(2)
    bench = R.load_bench(os.path.dirname(bench_dir))
    with f32_convs():
        run, checks, _ = R.execute(
            cell, seed, seconds, False, device="cpu", bench=bench,
            bench_dir=bench_dir, t0=time.perf_counter(),
            workdir=os.path.join(os.path.dirname(bench_dir), "work"))
    return run, checks
