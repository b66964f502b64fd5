"""Scale rehearsal: the preprocessing, getitem and vote path at a
release's footprint on synthetic data, and its numbers.

    python -m deepviewagg_tpu_torch.cli.scale_rehearsal [--points 1e6]
        [--cameras 24] [--image 512 256] [--voxel 0.04] [--device cpu]

The port of the root ``scripts/scale_rehearsal.py``, with its defaults and
its keys: the preprocess wall time by part (scene, voxel grid, PCA + kNN,
mappings, render + save) and the host's peak RSS, the getitem latency
(mean, p90) and the vote accumulation's RSS growth under the out-of-core
budget.  The device work (PCA, kNN, z-buffers, the full-resolution remap)
runs on the card unless ``--device cpu``; ``device`` and
``device_peak_mem_mb`` (``torch.cuda.max_memory_allocated``, 0 on the CPU)
sit beside the RSS.  Prints one JSON line; the scratch directory is removed
afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .train import setup_device

__all__ = ["main"]


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.scale_rehearsal")
    ap.add_argument("--points", type=float, default=1e6)
    ap.add_argument("--cameras", type=int, default=24)
    ap.add_argument("--image", type=int, nargs=2, default=[512, 256])
    ap.add_argument("--voxel", type=float, default=0.04)
    ap.add_argument("--getitems", type=int, default=20)
    ap.add_argument("--vote_budget_mb", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = setup_device(args.device)

    from ..data import synthetic
    from ..data.datasets.base import (AreaCache, SphereDataset, load_area,
                                      save_area)
    from ..data.geometric import pca_features
    from ..data.mapping_factory import VisibilityParams, build_mappings
    from ..metrics.tracker import VoteAccumulator
    from ..ops import voxel as _voxel

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # size the room so plane sampling yields ~args.points raw points
    room = (24.0, 18.0, 3.0)
    area_m2 = 2 * room[0] * room[1] + 2 * room[0] * room[2] \
        + 2 * room[1] * room[2]
    density = args.points / area_m2

    out = {"target_points": int(args.points), "cameras": args.cameras,
           "image_size": list(args.image), "device": str(device)}
    tmp = tempfile.mkdtemp(prefix="dva_scale_")
    path = os.path.join(tmp, "area_big.npz")

    def note(msg):
        print(f"[rehearsal] {msg}", file=sys.stderr, flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        t0 = time.time()
        note("scene...")
        scene = synthetic.make_scene(
            seed=0, room=room, density=density, n_boxes=10,
            n_cameras=args.cameras, image_size=tuple(args.image), r_max=16.0,
        )
        out["raw_points"] = int(len(scene.pos))
        t_scene = time.time()
        note(f"scene {t_scene - t0:.0f}s; voxelize...")
        g = _voxel.grid_sample(scene.pos, args.voxel, feats=scene.rgb,
                               labels=scene.labels)
        out["voxels"] = int(len(g["pos"]))
        t_voxel = time.time()
        note(f"voxelize {t_voxel - t_scene:.0f}s; pca...")
        geo = pca_features(g["pos"], k=30, device=device)
        sync()
        t_pca = time.time()
        note(f"pca {t_pca - t_voxel:.0f}s; mappings...")
        mapping = build_mappings(
            g["pos"], scene.cameras,
            VisibilityParams(voxel=args.voxel, max_splat=5),
            geometric=geo, nn_idx=geo["nn_idx"], device=device,
        )
        sync()
        t_map = time.time()
        note(f"mappings {t_map - t_pca:.0f}s; render+save...")
        imgs = synthetic.render_views(scene, mapping)
        save_area(path, {
            "pos": g["pos"], "rgb": g["feats"], "labels": g["labels"],
            "normal": geo["normal"].cpu().numpy(),
            "origin_id": np.arange(len(g["pos"]), dtype=np.int64),
            "mapping": mapping, "images": imgs,
            "raw_pos": scene.pos, "raw_labels": scene.labels,
        })
        del geo
        t1 = time.time()
        out.update({
            "t_scene_s": round(t_scene - t0, 1),
            "t_voxelize_s": round(t_voxel - t_scene, 1),
            "t_pca_s": round(t_pca - t_voxel, 1),
            "t_mappings_s": round(t_map - t_pca, 1),
            "t_render_save_s": round(t1 - t_map, 1),
            "t_preprocess_total_s": round(t1 - t0, 1),
            "preprocess_peak_rss_mb": round(rss_mb(), 1),
            "views": int(mapping.num_views),
            "pixels": int(mapping.num_pixels),
            "cache_mb": round(sum(
                os.path.getsize(os.path.join(tmp, f))
                for f in os.listdir(tmp)) / 2**20, 1),
        })

        ds = SphereDataset(
            areas=AreaCache([path], max_loaded=1), radius=2.5,
            voxel_size=args.voxel, num_classes=4, train=True, image_slots=4,
            samples_per_epoch=args.getitems,
        )
        lat = []
        for i in range(args.getitems):
            t = time.time()
            ds[i]
            lat.append(time.time() - t)
        out["getitem_mean_s"] = round(float(np.mean(lat)), 3)
        out["getitem_p90_s"] = round(float(np.percentile(lat, 90)), 3)

        # eval-vote accumulation at full res under the out-of-core budget
        votes = VoteAccumulator(4,
                                ram_budget_bytes=args.vote_budget_mb << 20)
        rng = np.random.default_rng(0)
        area = load_area(path)
        n = len(area["pos"])
        r0 = rss_mb()
        for _ in range(40):
            ids = rng.integers(0, n, 20000)
            votes.add(path, n, ids,
                      rng.normal(size=(20000, 4)).astype(np.float32))
        votes.preds(path)
        full = votes.full_res_preds(path, area["pos"], area["raw_pos"],
                                    device=device)
        out["vote_spilled_clouds"] = votes.spilled
        out["vote_rss_growth_mb"] = round(rss_mb() - r0, 1)
        out["full_res_points"] = int(len(full))
        out["device_peak_mem_mb"] = round(
            torch.cuda.max_memory_allocated(device) / 2**20, 1) \
            if device.type == "cuda" else 0.0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
