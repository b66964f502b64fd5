"""Single-cloud inference: ``python -m deepviewagg_tpu_torch.cli.predict
--run_dir runs/x --input cloud.ply [--device cpu]``.

The port of the root ``predict.py``, the CLI face of
:class:`~deepviewagg_tpu_torch.data.inference_transform.ModelInference`
(the reference ships this capability as inference notebooks,
README.md:88-92, and the ModelInference transform,
core/data_transform/inference_transforms.py): load a trained 3D checkpoint,
voxelize the input cloud at the stored voxel size, forward on one card
unless ``--device cpu`` is given, and write a PLY with per-voxel predicted
labels (plus class-colored rgb for quick viewing).

Input: ``.ply`` (x/y/z [+ red/green/blue]) or ``.npz`` with ``pos`` [N,3]
(+ optional ``rgb`` [N,3] in [0,1] or [0,255]).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.inference_transform import ModelInference
from ..utils.ply import read_ply, write_ply
from .train import setup_device

__all__ = ["main"]


def _load_cloud(path: str) -> dict:
    if path.endswith(".npz"):
        z = np.load(path)
        cloud = {"pos": np.asarray(z["pos"], np.float32)}
        if "rgb" in z.files:
            rgb = np.asarray(z["rgb"], np.float32)
            cloud["rgb"] = rgb / 255.0 if rgb.max() > 1.5 else rgb
        return cloud
    v = read_ply(path)
    cloud = {"pos": np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)}
    if "red" in v:
        cloud["rgb"] = np.stack(
            [v["red"], v["green"], v["blue"]], axis=1
        ).astype(np.float32) / 255.0
    return cloud


def _palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    pal = (rng.random((max(n, 1), 3)) * 200 + 55).astype(np.uint8)
    pal[: min(n, 6)] = [[31, 119, 180], [255, 127, 14], [44, 160, 44],
                        [214, 39, 40], [148, 103, 189], [140, 86, 75]][: min(n, 6)]
    return pal


def main(argv=None) -> str:
    """Returns the path of the PLY written."""
    parser = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.predict")
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--input", required=True, help=".ply or .npz cloud")
    parser.add_argument("--output", default=None, help="output .ply path")
    parser.add_argument("--weight", default="latest")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)
    device = setup_device(args.device)

    cloud = _load_cloud(args.input)
    print(f"loaded {len(cloud['pos'])} points from {args.input}")
    infer = ModelInference(args.run_dir, feat_name="pred", weight=args.weight,
                           output="labels", device=device)
    out = infer(cloud)
    pred = out["pred"]
    n_classes = infer.cfg.data.num_classes
    counts = np.bincount(pred, minlength=n_classes)
    print("predicted label histogram:",
          {c: int(v) for c, v in enumerate(counts) if v})

    dst = args.output or os.path.splitext(args.input)[0] + "_pred.ply"
    colors = _palette(n_classes)[np.clip(pred, 0, n_classes - 1)]
    write_ply(dst, {
        "x": out["pos"][:, 0], "y": out["pos"][:, 1], "z": out["pos"][:, 2],
        "red": colors[:, 0], "green": colors[:, 1], "blue": colors[:, 2],
        "label": pred.astype(np.int32),
    })
    print(f"wrote {dst} ({len(pred)} voxels, {n_classes} classes)")
    return dst


if __name__ == "__main__":
    main()
