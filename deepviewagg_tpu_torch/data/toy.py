"""Flagship-shaped synthetic batches for benchmarks, graft entry and smoke
tests.

Builds batches shaped like the reference's S3DIS training regime
(scripts/train_s3dis.sh: batch of 2 m-radius spheres at 5 cm grid, a handful
of equirectangular crops per sphere) but from the synthetic room generator —
so every harness (chip_smoke.py, the port's tests) exercises the exact
production code path without dataset downloads.  The mapping preprocessing
runs on ``device``; the returned batch is host numpy
(:func:`deepviewagg_tpu_torch.data.collate.batch_to_torch` moves it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..models.segmentation import BranchSpec, ModelSpec
from ..ops import voxel
from .collate import Bucket, Sample, collate
from .crop_groups import (assign_crop_groups, crop_ladder,
                          split_mapping_by_bucket)
from .mapping_factory import VisibilityParams, build_mappings
from . import synthetic

__all__ = ["flagship_spec", "toy_batch", "toy_samples", "recipe_batch"]

NUM_CLASSES = 4  # synthetic room classes


def flagship_spec(
    num_classes: int = NUM_CLASSES,
    backbone: str = "Res16UNet34",
    tower: str = "resnet18_ppm",
    num_groups: int = 4,
) -> ModelSpec:
    """The paper's model shape: Res16UNet34 + early-fused image branch with
    group-attention view pooling and bilinear interpolation
    (Res16UNet34-L4-early-*-interpolate, README.md:106)."""
    return ModelSpec(
        num_classes=num_classes,
        in_channels=4,
        backbone=backbone,
        # the reference flagship uses a kernel-3 stem (multimodal
        # sparseconv3d.yaml:6622 kernel_size [3,2,2,2,2]; 5 never appears in
        # the MM zoo)
        stem_kernel=3,
        branches=(
            (0, BranchSpec(
                tower=tower, out_channels=64, view_pool="group",
                num_groups=num_groups, interpolate=True,
                # early fusion is pre-stem; the reference's early models all
                # CONCAT there (residual early would bottleneck through the
                # raw feature width)
                fusion_mode="concat", remat_tower="convs",
                # pool_bf16 stays off: f32 pixel features keep the atomic
                # pool exact
            )),
        ),
    )


def toy_samples(
    n_samples: int = 2,
    density: float = 120.0,
    image_size: Tuple[int, int] = (128, 64),
    n_cameras: int = 2,
    voxel_size: float = 0.1,
    seed: int = 0,
    device="cuda",
):
    samples = []
    for s in range(n_samples):
        scene = synthetic.make_scene(
            seed=seed + s, density=density, n_cameras=n_cameras,
            image_size=image_size,
        )
        g = voxel.grid_sample(
            scene.pos, voxel_size, feats=scene.rgb, labels=scene.labels
        )
        mapping = build_mappings(
            g["pos"], scene.cameras,
            VisibilityParams(voxel=voxel_size, max_splat=5), device=device,
        )
        imgs = synthetic.render_views(scene, mapping)
        feats = np.concatenate(
            [g["feats"], np.ones((len(g["coords"]), 1), np.float32)], axis=1
        )
        samples.append(Sample(
            coords=g["coords"][:, 1:], feats=feats, labels=g["labels"],
            images=imgs, mapping=mapping, pos=g["pos"],
        ))
    return samples


def _level_counts(samples):
    """Exact voxel counts of the five UNet levels of the samples as one
    batch, to size a bucket."""
    coords = np.concatenate([
        np.concatenate([np.full((len(s.coords), 1), b, np.int32),
                        s.coords.astype(np.int32)], axis=1)
        for b, s in enumerate(samples)
    ])
    counts, cur, stride = [len(coords)], coords, 1
    for _ in range(4):
        cur, _ = voxel.downsample_coords(cur, stride * 2)
        stride *= 2
        counts.append(len(cur))
    return counts


def toy_batch(
    n_samples: int = 2,
    density: float = 120.0,
    image_size: Tuple[int, int] = (128, 64),
    n_cameras: int = 2,
    voxel_size: float = 0.1,
    branch_levels=(0,),
    seed: int = 0,
    headroom: float = 1.1,
    conv0_kernel: int = 3,
    device="cuda",
):
    """One collated batch with capacities sized from the sample contents."""
    samples = toy_samples(n_samples, density, image_size, n_cameras,
                          voxel_size, seed, device=device)
    views = sum(s.mapping.num_views for s in samples)
    pix = sum(s.mapping.num_pixels for s in samples)

    def cap(x, m=256):
        return int(-(-int(x * headroom) // m) * m)

    bucket = Bucket(
        level_caps=[cap(c) for c in _level_counts(samples)],
        num_batches=n_samples,
        view_cap=cap(views), pix_cap=cap(pix),
        image_cap=n_samples * n_cameras,
        image_size=image_size,
    )
    batch = collate(samples, bucket, branch_levels=branch_levels,
                    conv0_kernel=conv0_kernel)
    return batch, bucket, samples


def recipe_batch(
    n_samples: int = 2,
    density: float = 260.0,
    image_size: Tuple[int, int] = (1024, 512),
    n_cameras: int = 2,
    voxel_size: float = 0.1,
    branch_levels=(0,),
    seed: int = 0,
    headroom: float = 1.3,
    min_size: int = 64,
    conv0_kernel: int = 3,
    device="cuda",
):
    """One collated crop-ladder batch at the S3DIS recipe's 2D resolution
    (1024 x 512 panoramas, ``resolution_2d`` of conf/s3dis_benchmark.yaml):
    every image is cropped to the smallest size of the power-of-two ladder
    ``crop_ladder(image_size, min_size)`` that holds its mapped pixels and
    shipped in that size's bucket, with per-bucket pixel tables over one
    global view table.  Bucket capacities are sized from the sample
    contents (at least one image and 256 pixel rows per ladder size).  The
    defaults are the recipe-scale request of the benchmark; tests pass small
    sizes.  Built anew on every call (nothing is cached on disk)."""
    samples = toy_samples(n_samples, density, image_size, n_cameras,
                          voxel_size, seed, device=device)
    ladder = crop_ladder(image_size, min_size=min_size)

    def cap(x, m=256):
        return int(-(-int(x * headroom) // m) * m)

    # per-bucket pixel and image maxima
    b_pix = [0] * len(ladder)
    b_img = [0] * len(ladder)
    for s in samples:
        ass = assign_crop_groups({"mapping": s.mapping, "images": s.images},
                                 ladder)
        mmp = split_mapping_by_bucket(ass, ladder, include_images=False)
        for bi, bk in enumerate(mmp["buckets"]):
            b_pix[bi] += len(bk["pix_view"])
            b_img[bi] += int((ass["image_bucket"] == bi).sum())
    views = sum(s.mapping.num_views for s in samples)
    pix = sum(s.mapping.num_pixels for s in samples)
    bucket = Bucket(
        level_caps=[cap(c) for c in _level_counts(samples)],
        num_batches=len(samples),
        view_cap=cap(views), pix_cap=cap(pix),
        image_cap=sum(b_img),
        image_size=image_size,
        image_ladder=ladder,
        ladder_image_caps=[max(1, i) for i in b_img],
        ladder_pix_caps=[max(cap(p), 256) for p in b_pix],
    )
    batch = collate(samples, bucket, branch_levels=branch_levels,
                    conv0_kernel=conv0_kernel)
    return batch, bucket, samples
