"""One-time dataset preprocessing, separated from training so it can run
as a batch job, sharded across hosts by index:

    python -m deepviewagg_tpu_torch.cli.preprocess --dataset s3dis \\
        --root /data/s3dis --out /data/s3dis/processed_dva --voxel-size 0.05
    python -m deepviewagg_tpu_torch.cli.preprocess --dataset kitti360 \\
        --root /data/kitti360 --shard 0 --num-shards 8   # one shard

The port of the root ``scripts/preprocess.py`` (the reference's
``dataset.process()`` stage): the same options and shard assignment (the
``i``-th area, scan or window of the sorted listing goes to shard ``i %
num_shards``), the port's ``preprocess_s3dis_area`` /
``preprocess_scannet_scan`` / ``preprocess_kitti360_window`` /
``build_synthetic_cache`` on the card unless ``--device cpu``.  The caches
are the ones ``cli.train`` builds in-line with the loaders' defaults (the
voxel size aside): point ``data.root`` at the same root and training
finds them.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from .train import setup_device

__all__ = ["main"]


def _shard(items, shard: int, num_shards: int):
    return [x for i, x in enumerate(items) if i % num_shards == shard]


def main(argv=None) -> list:
    """Returns the cache paths this shard wrote (or found)."""
    p = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.preprocess")
    p.add_argument("--dataset", required=True,
                   choices=["s3dis", "scannet", "kitti360", "synthetic"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--voxel-size", type=float, default=0.05)
    p.add_argument("--image-size", type=int, nargs=2, default=None)
    p.add_argument("--keep-raw", action="store_true")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = setup_device(args.device)
    out = args.out or os.path.join(args.root, "processed_dva")
    kw = {"image_size": tuple(args.image_size)} if args.image_size else {}
    written = []

    def run(label, fn, *fn_args, **fn_kw):
        t0 = time.perf_counter()
        path = fn(*fn_args, device=device, **fn_kw)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{label} -> {path} ({ms:.0f} ms)", flush=True)
        written.append(path)

    if args.dataset == "s3dis":
        from ..data.datasets.s3dis import preprocess_s3dis_area

        areas = [a for a in range(1, 7)
                 if os.path.isdir(os.path.join(args.root, f"Area_{a}"))]
        for a in _shard(areas, args.shard, args.num_shards):
            run(f"area {a}", preprocess_s3dis_area, args.root, a, out,
                voxel_size=args.voxel_size, keep_raw=args.keep_raw, **kw)
    elif args.dataset == "scannet":
        from ..data.datasets.scannet import preprocess_scannet_scan

        scans = sorted(glob.glob(os.path.join(args.root, "scans", "scene*")))
        for s in _shard(scans, args.shard, args.num_shards):
            run(os.path.basename(s), preprocess_scannet_scan, s, out,
                voxel_size=args.voxel_size, **kw)
    elif args.dataset == "kitti360":
        from ..data.datasets.kitti360 import preprocess_kitti360_window

        plys = sorted(glob.glob(os.path.join(
            args.root, "data_3d_semantics", "*", "static", "*.ply")))
        for w in _shard(plys, args.shard, args.num_shards):
            run(os.path.basename(w), preprocess_kitti360_window, args.root,
                w, out, voxel_size=args.voxel_size, **kw)
    else:
        from ..data.datasets.synthetic_ds import build_synthetic_cache

        t0 = time.perf_counter()
        paths = build_synthetic_cache(out, keep_raw=args.keep_raw,
                                      device=device)
        print(f"synthetic -> {paths} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)", flush=True)
        written.extend(paths)
    return written


if __name__ == "__main__":
    main()
