"""The S3DIS loader of the PyTorch port against the JAX package, on a
miniature 2D-3D-S raw layout (``torch_port_util.fake_s3dis_layout``: one
room, 256 x 128 panoramas read at 128 x 64, so that the bilinear resize
runs, with a static band of rows that the non-static mask drops).

The txt reads, the voxel grid, the PNG decode and resize (the port's own,
without PIL), the non-static mask and the sphere sampling are host numpy:
byte-identical to the JAX package.  The kNN, PCA and the exact z-buffers run
in torch: the normals and the view features agree within 1e-4 (as
``test_torch_port_datasets.py`` holds the synthetic caches), and on this
layout every index array of the mapping is equal.  Samples of
``make_s3dis_dataset`` from one cache and one seed are byte-identical, the
recipe's augmentations included.  Then a CPU smoke of ``cli.train`` and
``cli.eval --full_res`` on the layout."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import s3dis as js
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import s3dis as ts
from torch_port_util import (_torch_threads, assert_identical,  # noqa: F401
                             fake_s3dis_layout)

PRE = dict(voxel_size=0.1, image_size=(128, 64), keep_raw=True)
HOST_KEYS = ("pos", "rgb", "labels", "origin_id", "images", "raw_pos",
             "raw_labels")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return fake_s3dis_layout(str(tmp_path_factory.mktemp("s3dis") / "raw"))


@pytest.fixture(scope="module")
def jax_caches(layout, tmp_path_factory):
    """``cache_dir`` of both folds preprocessed by the JAX package."""
    out = str(tmp_path_factory.mktemp("jax_cache"))
    for area in (1, 5):
        js.preprocess_s3dis_area(layout, area, out, **PRE)
    return out


def test_classes_and_room_read_identical(layout):
    assert ts.S3DIS_CLASSES == js.S3DIS_CLASSES
    assert ts.NUM_CLASSES == js.NUM_CLASSES == 13
    room = os.path.join(layout, "Area_1", "office_1")
    ref, got = js.load_s3dis_room(room), ts.load_s3dis_room(room)
    assert_identical(ref, got)
    # wall, chair and the unknown "stairs" read as clutter
    assert set(np.unique(got[2]).tolist()) == {2, 7, 12}
    with pytest.raises(FileNotFoundError):
        ts.load_s3dis_room(layout)


def test_poses_and_cameras_identical(layout):
    area = os.path.join(layout, "Area_5")          # through the symlink
    ref, got = js.area_cameras(area, (128, 64)), ts.area_cameras(area,
                                                                 (128, 64))
    assert len(ref) == len(got) == 2
    for a, b in zip(ref, got):
        assert a["path"] == b["path"]
        for f in dataclasses.fields(a["camera"]):
            assert_identical(getattr(a["camera"], f.name),
                             getattr(b["camera"], f.name), f.name)
        assert_identical(js.read_s3dis_pose(a["path"].replace(
            "/rgb/", "/pose/").replace("_rgb.png", "_pose.json")),
            ts.read_s3dis_pose(b["path"].replace(
                "/rgb/", "/pose/").replace("_rgb.png", "_pose.json")))


def _mapping_fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("kw", [
    {}, dict(max_images=1), dict(exact_splatting=False, n_sample=2)],
    ids=["recipe", "max_images", "splat"])
def test_preprocess_matches_jax(layout, tmp_path, kw):
    """The area cache of both packages on the same layout: the host arrays
    byte-identical, normals and view features within 1e-4, every mapping
    index array equal; exact splatting maps at most one pixel per (point,
    view), and the static rows keep none."""
    jp = js.preprocess_s3dis_area(layout, 1, str(tmp_path / "j"), **PRE, **kw)
    tp = ts.preprocess_s3dis_area(layout, 1, str(tmp_path / "t"),
                                  device="cpu", **PRE, **kw)
    ref, got = jbase.load_area(jp), tbase.load_area(tp)
    assert sorted(ref) == sorted(got)
    for key in HOST_KEYS:
        assert_identical(np.asarray(ref[key]), np.asarray(got[key]), key)
    assert np.abs(ref["normal"] - got["normal"]).max() <= 1e-4
    rm, gm = _mapping_fields(ref["mapping"]), _mapping_fields(got["mapping"])
    assert isinstance(got["mapping"], tmapping.MultiViewMapping)
    for name in rm:
        if name == "view_feats":
            assert np.abs(rm[name] - gm[name]).max() <= 1e-4
        else:
            assert_identical(rm[name], gm[name], name)
    m = got["mapping"]
    m.check()
    assert m.num_images == len(got["images"]) == kw.get("max_images", 2)
    per_view = np.bincount(m.pix_view[m.pix_valid])
    exact = kw.get("exact_splatting", True)
    assert bool(per_view.max() == 1) == exact
    assert m.pix_valid.sum() > 500
    # the bottom 16 of 128 rows are static: after the resize to 64 rows, the
    # last 7 (row 56's filter still reads row 111, which differs); one image
    # alone has no static pixels
    assert (m.pix_y[m.pix_valid].max() < 64 - 7) == (m.num_images > 1)
    # an existing cache is not rebuilt
    assert ts.preprocess_s3dis_area(layout, 1, str(tmp_path / "t"),
                                    device="cpu", **PRE) == tp


def test_default_augment_matches_jax():
    ref, got = js.default_augment(), ts.default_augment()
    assert [type(t).__name__ for t in ref.transforms] == [
        type(t).__name__ for t in got.transforms]
    for a, b in zip(ref.transforms, got.transforms):
        assert vars(a) == vars(b)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dataset_samples_identical(layout, jax_caches, train):
    """``make_s3dis_dataset`` of both packages on the JAX package's caches:
    the recipe's defaults (roll, flip, mapping and colour jitter at train,
    the S3DIS augmentation chain) give byte-identical samples."""
    kw = dict(train=train, fold=5, radius=1.5, voxel_size=0.1,
              image_slots=2, samples_per_epoch=5, cache_dir=jax_caches,
              image_size=(128, 64), keep_raw=True)
    jds = js.make_s3dis_dataset(layout, **kw)
    tds = ts.make_s3dis_dataset(layout, device="cpu", **kw)
    assert tds.areas.paths == jds.areas.paths == [
        os.path.join(jax_caches, f"area_{1 if train else 5}.npz")]
    for field in ("radius", "voxel_size", "num_classes", "train",
                  "image_slots", "samples_per_epoch", "center_roll", "flip_p",
                  "jitter_mapping", "color_jitter"):
        assert getattr(tds, field) == getattr(jds, field), field
    assert (tds.augment is None) is (not train)
    assert len(jds) == len(tds) > 1
    seen = 0
    for i in range(len(jds)):
        ref, got = jds[i], tds[i]
        if ref is None:
            assert got is None
            continue
        assert_identical(ref, got)
        seen += got.mapping is not None and got.mapping.num_views > 0
    assert seen


def test_folds_follow_the_six_fold_protocol(layout, jax_caches, tmp_path):
    """Fold 5 is the eval area, the rest train; a fold without areas
    raises."""
    assert ts.make_s3dis_dataset(layout, train=True, fold=1,
                                 cache_dir=jax_caches, device="cpu",
                                 **PRE).areas.paths == [
        os.path.join(jax_caches, "area_5.npz")]
    with pytest.raises(FileNotFoundError, match="eval fold 3"):
        ts.make_s3dis_dataset(layout, train=False, fold=3, device="cpu")
    with pytest.raises(FileNotFoundError, match="train fold 5"):
        ts.make_s3dis_dataset(str(tmp_path), train=True, device="cpu")


def test_cli_trains_and_evaluates_full_res_on_the_layout(layout, tmp_path,
                                                         capsys):
    """``cli.train`` with the S3DIS recipe's config on the layout (a small
    model and 128 x 64 panoramas), then ``cli.eval --voting_runs 2
    --full_res``: the cache keeps the raw cloud, and the remap gives one
    prediction per raw point."""
    # a copy of the layout (Area_5 still a symlink into the shared one), so
    # that this run's caches land under this test's own processed_dva
    root = str(tmp_path / "raw")
    shutil.copytree(layout, root, symlinks=True,
                    ignore=shutil.ignore_patterns("processed_dva"))
    run = tmp_path / "run"
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "conf", "s3dis_benchmark.yaml")
    metrics = cli_train.main([
        "--config", cfg, "--device", "cpu", f"data.root={root}",
        f"training.run_dir={run}", "training.epochs=1",
        "training.eval_frequency=1", "training.tensorboard=false",
        "model.name=Res16UNet14-L1-early-group2",
        "model.overrides={backbone: Res16UNetTest}", "data.voxel_size=0.1",
        "data.radius=1.5", "data.batch_size=2", "data.image_slots=2",
        "data.samples_per_epoch=4", "data.image_size=[128, 64]",
        "data.kwargs={fold: 5, keep_raw: true, image_size: [128, 64]}"])
    assert np.isfinite(metrics["val_miou"])
    stored = json.loads((run / "run.json").read_text())
    assert stored["data"]["dataset"] == "s3dis"
    cache = tbase.load_area(os.path.join(root, "processed_dva",
                                         "area_5.npz"))
    capsys.readouterr()
    out = cli_eval.main(["--run_dir", str(run), "--device", "cpu",
                         "--voting_runs", "2", "--full_res"])
    printed = capsys.readouterr().out
    assert "voting run 1:" in printed
    assert f"full_res remap area_5.npz: {len(cache['raw_pos'])} raw" \
        in printed
    for key in ("test_miou", "vote_miou", "full_res_miou"):
        assert np.isfinite(out[key]), key
