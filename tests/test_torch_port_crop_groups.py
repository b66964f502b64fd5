"""The crop-ladder host code of the PyTorch port against the JAX package:
``crop_ladder``, ``assign_crop_groups`` and ``split_mapping_by_bucket`` are
numpy copies and must give byte-identical arrays on the same samples; the
port's ``recipe_batch`` builds, at a small size, the bucket that the
benchmark's recipe-scale batch function would, and a batch the JAX package's
``collate`` reproduces byte for byte from the same samples."""

import dataclasses

import pytest

from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data import crop_groups as jcg
from deepviewagg_tpu.data import mapping as jmapping
from deepviewagg_tpu_torch.data import crop_groups as tcg
from deepviewagg_tpu_torch.data import toy as ttoy
from test_torch_port_data import assert_trees_identical
from torch_port_util import (LADDER, _torch_threads,  # noqa: F401
                             jax_ladder_samples, to_torch_samples)


@pytest.mark.parametrize("size,min_size", [((1024, 512), 64), ((64, 32), 4),
                                           ((256, 128), 128), ((96, 48), 16),
                                           ((64, 64), 64)])
def test_crop_ladder_identical(size, min_size):
    ref = jcg.crop_ladder(size, min_size=min_size)
    assert tcg.crop_ladder(size, min_size=min_size) == ref
    assert ref[-1] == tuple(size) and ref == sorted(ref)


def test_recipe_ladder_has_four_sizes():
    assert tcg.crop_ladder((1024, 512), min_size=64) == [
        (128, 64), (256, 128), (512, 256), (1024, 512)]


@pytest.mark.parametrize("sample", [0, 1])
def test_assign_crop_groups_identical(sample):
    js = jax_ladder_samples()[sample]
    ts = to_torch_samples([js])[0]
    ref = jcg.assign_crop_groups({"mapping": js.mapping, "images": js.images},
                                 LADDER)
    got = tcg.assign_crop_groups({"mapping": ts.mapping, "images": ts.images},
                                 LADDER)
    for key in ("image_bucket", "crop_origin"):
        assert_trees_identical(ref[key], got[key])
    # the windowed image went down the ladder, the other one fills the frame
    assert got["image_bucket"].tolist() == [[2, 3], [1, 3]][sample]
    assert (got["crop_origin"][0] > 0).all()
    assert (got["crop_origin"][1] == 0).all()


@pytest.mark.parametrize("include_images", [False, True])
@pytest.mark.parametrize("sample", [0, 1])
def test_split_mapping_by_bucket_identical(sample, include_images):
    js = jax_ladder_samples()[sample]
    ts = to_torch_samples([js])[0]
    ref = jcg.split_mapping_by_bucket(
        jcg.assign_crop_groups({"mapping": js.mapping, "images": js.images},
                               LADDER), LADDER, include_images=include_images)
    got = tcg.split_mapping_by_bucket(
        tcg.assign_crop_groups({"mapping": ts.mapping, "images": ts.images},
                               LADDER), LADDER, include_images=include_images)
    assert_trees_identical(ref, got)
    assert ("images" in got["buckets"][3]) == include_images
    # every valid pixel lies in exactly one bucket, inside that bucket's crop
    assert sum(len(b["pix_view"]) for b in got["buckets"]) \
        == js.mapping.num_pixels
    for b, (cw, ch) in zip(got["buckets"], LADDER):
        if len(b["pix_x"]):
            assert b["pix_x"].max() < cw and b["pix_y"].max() < ch


def test_image_bboxes_identical():
    js = jax_ladder_samples()[0]
    ts = to_torch_samples([js])[0]
    assert_trees_identical(jcg._image_bboxes(js.mapping),
                           tcg._image_bboxes(ts.mapping))


def test_recipe_batch_is_what_the_jax_collate_gives(monkeypatch):
    """``recipe_batch`` at a small size, on the JAX package's samples: its
    bucket follows the rules of the benchmark's recipe batch, and the JAX package's
    ``collate`` gives the same bytes from the same samples and bucket."""
    from deepviewagg_tpu.data.toy import toy_samples as jax_toy_samples

    jsamples = jax_toy_samples(2, 30.0, (64, 32), 2, 0.15, 3)
    monkeypatch.setattr(ttoy, "toy_samples",
                        lambda *a, **k: to_torch_samples(jsamples))
    batch, bucket, samples = ttoy.recipe_batch(
        2, 30.0, (64, 32), 2, 0.15, branch_levels=(0, 1), seed=3, min_size=8,
        device="cpu")
    ladder = jcg.crop_ladder((64, 32), min_size=8)
    assert [tuple(s) for s in bucket.image_ladder] == ladder and len(ladder) == 3
    pix = sum(s.mapping.num_pixels for s in samples)
    views = sum(s.mapping.num_views for s in samples)
    # panoramas fill their frame: every image lands in the largest size, the
    # smaller ones keep one image slot and 256 pixel rows each
    assert list(bucket.ladder_image_caps) == [1, 1, 4]
    assert list(bucket.ladder_pix_caps)[:2] == [256, 256]
    assert bucket.ladder_pix_caps[2] == -(-int(pix * 1.3) // 256) * 256
    assert bucket.view_cap == -(-int(views * 1.3) // 256) * 256
    assert bucket.image_cap == 4 and tuple(bucket.image_size) == (64, 32)
    jbucket = jcollate.Bucket(**dataclasses.asdict(bucket))
    ref = jcollate.collate(list(jsamples), jbucket, branch_levels=(0, 1))
    drop_meta = lambda b: {k: v for k, v in b.items() if k != "meta"}  # noqa: E731
    assert_trees_identical(drop_meta(ref), drop_meta(batch))
    assert ref["meta"]["num_valid"] == batch["meta"]["num_valid"]
    mm = batch["mappings"][0]
    assert [int(b["pix_valid"].sum()) for b in mm["buckets"]] == [0, 0, pix]
    assert not isinstance(samples[0].mapping, jmapping.MultiViewMapping)


def test_recipe_batch_defaults_are_the_recipe_request():
    import inspect

    p = inspect.signature(ttoy.recipe_batch).parameters
    got = {k: p[k].default for k in (
        "n_samples", "density", "image_size", "n_cameras", "voxel_size",
        "seed", "headroom", "min_size", "branch_levels", "device")}
    assert got == dict(n_samples=2, density=260.0, image_size=(1024, 512),
                       n_cameras=2, voxel_size=0.1, seed=0, headroom=1.3,
                       min_size=64, branch_levels=(0,), device="cuda")
