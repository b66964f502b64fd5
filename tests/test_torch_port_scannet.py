"""The ScanNet loader of the PyTorch port against the JAX package, on a
miniature ScanNet v2 layout (``torch_port_util.fake_scannet_layout``: three
scans, 128 x 96 JPEG frames written by the port's ``write_jpeg`` and read at
64 x 48, a pose without colour between kept frames, a non-finite pose, the
split lists).

The PLY and txt reads, the voxel grid, the JPEG decode and resize (the
port's own, without PIL), the coverage selection, the non-static mask and
the sphere sampling are host numpy: byte-identical to the JAX package.  The
kNN, PCA and z-buffers run in torch: the normals and the view features
agree within 1e-4 (as ``test_torch_port_s3dis.py`` holds them), and every
index array of the mapping is equal.  Samples of ``make_scannet_dataset``
from one cache and one seed are byte-identical; the 90/10 split without
lists and its warning are the JAX one's; ``write_submission`` writes the
same bytes; one float32 train step on the loader's first batch matches the
JAX step's loss within 1e-5.  Then a CPU smoke of ``cli.train`` and
``cli.eval --voting_runs 2 --submission``."""

import dataclasses
import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import scannet as js
from deepviewagg_tpu.models.segmentation import build_model as jax_build
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.data import collate as tcollate
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import scannet as ts
from deepviewagg_tpu_torch.models.segmentation import build_model
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import (SCANNET_SCANS, _torch_threads,  # noqa: F401
                             assert_identical, f32_sparse_convs,
                             fake_scannet_layout, jax_variables)

PRE = dict(voxel_size=0.1, image_size=(64, 48), frame_step=2)
HOST_KEYS = ("pos", "rgb", "labels", "origin_id", "images")
FEATS_ATOL = 1e-4
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf", "scannet_benchmark.yaml")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return fake_scannet_layout(str(tmp_path_factory.mktemp("scannet")
                                   / "raw"))


@pytest.fixture(scope="module")
def jax_caches(layout, tmp_path_factory):
    """``cache_dir`` of every scan preprocessed by the JAX package."""
    out = str(tmp_path_factory.mktemp("jax_cache"))
    for scan in SCANNET_SCANS:
        js.preprocess_scannet_scan(os.path.join(layout, "scans", scan), out,
                                   **PRE)
    return out


def _scan(layout, i=0):
    return os.path.join(layout, "scans", SCANNET_SCANS[i])


def test_classes_and_label_table_identical():
    assert ts.SCANNET_CLASSES == js.SCANNET_CLASSES
    assert ts.VALID_CLASS_IDS == js.VALID_CLASS_IDS
    assert ts.NUM_CLASSES == js.NUM_CLASSES == 20
    assert_identical(js._NYU40_TO_TRAIN, ts._NYU40_TO_TRAIN)
    assert (ts.IMG_SIZE, ts.R_MIN, ts.R_MAX) == (js.IMG_SIZE, js.R_MIN,
                                                 js.R_MAX)


@pytest.mark.parametrize("scan", [0, 1])
def test_scan_cloud_and_poses_identical(layout, scan):
    """The mesh (the first scan's PLY carries a face list), the NYU40 ->
    train-id labels (13 and 0 read -1), every pose file."""
    d = _scan(layout, scan)
    ref, got = js.load_scan_cloud(d), ts.load_scan_cloud(d)
    assert_identical(ref, got)
    assert set(np.unique(got[2]).tolist()) == {-1, 0, 1}
    for name in sorted(os.listdir(os.path.join(d, "pose"))):
        path = os.path.join(d, "pose", name)
        assert_identical(js.load_pose(path), ts.load_pose(path))


def test_scan_without_labels_reads_ignore(layout, tmp_path):
    d = str(tmp_path / SCANNET_SCANS[0])
    shutil.copytree(_scan(layout), d)
    os.remove(os.path.join(d, f"{SCANNET_SCANS[0]}_vh_clean_2.labels.ply"))
    ref, got = js.load_scan_cloud(d), ts.load_scan_cloud(d)
    assert_identical(ref, got)
    assert (got[2] == -1).all()


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("size", [(64, 48), (320, 240)])
def test_scan_cameras_identical(layout, step, size):
    """Every ``frame_step``-th pose; frames without colour and the
    non-finite pose skipped; intrinsics rescaled from the first frame's
    JPEG header (``jpeg_size``; the JAX package asks PIL)."""
    ref = js.scan_cameras(_scan(layout), size, frame_step=step)
    got = ts.scan_cameras(_scan(layout), size, frame_step=step)
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert a["path"] == b["path"]
        for f in dataclasses.fields(a["camera"]):
            assert_identical(getattr(a["camera"], f.name),
                             getattr(b["camera"], f.name), f.name)
    k = got[0]["camera"].intrinsic
    assert k[0, 0] == pytest.approx(0.8 * size[0])  # 0.8 W at any W


def _mapping_fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("kw", [
    {}, dict(max_images=2), dict(exact_splatting=True, n_sample=2)],
    ids=["recipe", "max_images", "exact"])
def test_preprocess_matches_jax(layout, tmp_path, kw):
    """The scan cache of both packages: the host arrays, images included,
    byte-identical; normals and view features within ``FEATS_ATOL``;
    every mapping index array equal."""
    jp = js.preprocess_scannet_scan(_scan(layout), str(tmp_path / "j"),
                                    **PRE, **kw)
    tp = ts.preprocess_scannet_scan(_scan(layout), str(tmp_path / "t"),
                                    device="cpu", **PRE, **kw)
    assert os.path.basename(tp) == f"{SCANNET_SCANS[0]}.npz"
    ref, got = jbase.load_area(jp), tbase.load_area(tp)
    assert sorted(ref) == sorted(got)
    for key in HOST_KEYS:
        assert_identical(np.asarray(ref[key]), np.asarray(got[key]), key)
    assert np.abs(ref["normal"] - got["normal"]).max() <= FEATS_ATOL
    rm, gm = _mapping_fields(ref["mapping"]), _mapping_fields(got["mapping"])
    assert isinstance(got["mapping"], tmapping.MultiViewMapping)
    for name in rm:
        if name == "view_feats":
            assert np.abs(rm[name] - gm[name]).max() <= FEATS_ATOL
        else:
            assert_identical(rm[name], gm[name], name)
    m = got["mapping"]
    m.check()
    assert m.num_images == len(got["images"]) == kw.get("max_images", 3)
    assert got["images"].shape[1:] == (64, 48, 3)
    assert m.pix_valid.sum() > 200
    per_view = np.bincount(m.pix_view[m.pix_valid])
    assert bool(per_view.max() == 1) == kw.get("exact_splatting", False)
    # an existing cache is not rebuilt
    assert ts.preprocess_scannet_scan(_scan(layout), str(tmp_path / "t"),
                                      device="cpu", **PRE) == tp


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dataset_samples_identical(layout, jax_caches, train):
    """``make_scannet_dataset`` of both packages on the JAX package's
    caches: the split lists pick the scans, the recipe's colour jitter and
    the S3DIS augmentation chain at train, byte-identical samples."""
    kw = dict(train=train, radius=1.5, image_slots=2, samples_per_epoch=5,
              cache_dir=jax_caches, **PRE)
    jds = js.make_scannet_dataset(layout, **kw)
    tds = ts.make_scannet_dataset(layout, device="cpu", **kw)
    want = SCANNET_SCANS[:-1] if train else SCANNET_SCANS[-1:]
    assert tds.areas.paths == jds.areas.paths == [
        os.path.join(jax_caches, f"{s}.npz") for s in want]
    for field in ("radius", "voxel_size", "num_classes", "train",
                  "image_slots", "samples_per_epoch", "color_jitter"):
        assert getattr(tds, field) == getattr(jds, field), field
    assert tds.color_jitter == ((0.6, 0.6, 0.7) if train else None)
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


def test_split_without_lists_is_90_10_with_a_warning(layout, jax_caches,
                                                     tmp_path):
    """No ``scannetv2_*.txt``: every tenth scan (the first of three) is
    the eval split, the others train, with the JAX package's warning; a
    root without scans raises."""
    root = str(tmp_path / "raw")
    os.makedirs(os.path.join(root, "scans"))
    for s in SCANNET_SCANS:
        os.symlink(_scan(layout, SCANNET_SCANS.index(s)),
                   os.path.join(root, "scans", s))
    for train in (True, False):
        kw = dict(train=train, cache_dir=jax_caches, **PRE)
        with pytest.warns(UserWarning, match="90/10"):
            jds = js.make_scannet_dataset(root, **kw)
        with pytest.warns(UserWarning, match="90/10"):
            tds = ts.make_scannet_dataset(root, device="cpu", **kw)
        want = SCANNET_SCANS[1:] if train else SCANNET_SCANS[:1]
        assert tds.areas.paths == jds.areas.paths == [
            os.path.join(jax_caches, f"{s}.npz") for s in want]
    with pytest.raises(FileNotFoundError, match="no scans"):
        ts.make_scannet_dataset(str(tmp_path), device="cpu")


def test_mapping_params_drop_like_jax(layout, jax_caches):
    """The reference data YAML's ``mapping_params``: the crop, upscale and
    feature switches are dropped, ``exact`` becomes ``exact_splatting``."""
    mp = dict(crop_padding=4, proj_upscale=2, density=True, occlusion=True,
              exact=False, r_max=6.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tds = ts.make_scannet_dataset(layout, train=False,
                                      cache_dir=jax_caches, device="cpu",
                                      mapping_params=mp, **PRE)
    assert tds.areas.paths == [os.path.join(jax_caches,
                                            f"{SCANNET_SCANS[-1]}.npz")]


def test_write_submission_identical(tmp_path):
    rng = np.random.default_rng(0)
    preds = {s: rng.integers(-1, 23, 50 + 7 * i)
             for i, s in enumerate(SCANNET_SCANS)}
    a = js.write_submission(str(tmp_path / "j"), preds)
    b = ts.write_submission(str(tmp_path / "t"), preds)
    for s in SCANNET_SCANS:
        ref = open(os.path.join(a, f"{s}.txt"), "rb").read()
        got = open(os.path.join(b, f"{s}.txt"), "rb").read()
        assert ref == got
        ids = np.loadtxt(os.path.join(b, f"{s}.txt"), dtype=np.int64)
        assert set(ids.tolist()) <= set(ts.VALID_CLASS_IDS)


# --- one train step on the loader's first batch -------------------------------

SPEC = ("Res16UNet14-L1-early-group2",
        {"backbone": "Res16UNetTest", "tower_bf16": False})


def test_first_batch_train_step_matches_jax(layout, jax_caches):
    """Both packages' ``BatchLoader`` give the same first batch of the
    ScanNet train set; one float32 train step (SGD + momentum, weight
    decay, clip; the convs' operands float32) from the same converted
    variables gives the same loss within 1e-5 and a finite, equal-sized
    update."""
    kw = dict(train=True, radius=1.5, image_slots=2, samples_per_epoch=4,
              cache_dir=jax_caches, **PRE)
    jds = js.make_scannet_dataset(layout, **kw)
    tds = ts.make_scannet_dataset(layout, device="cpu", **kw)
    caps = dict(level_caps=[4096, 2048, 1024, 512, 256], num_batches=2,
                view_cap=4096, pix_cap=16384, image_cap=4,
                image_size=(64, 48))
    from deepviewagg_tpu.data import collate as jcollate

    jbatch = next(iter(jbase.BatchLoader(jds, jcollate.Bucket(**caps), 2,
                                         [0], seed=1)))
    tbatch = next(iter(tbase.BatchLoader(tds, tcollate.Bucket(**caps), 2,
                                         [0], seed=1)))
    jbatch.pop("meta"), tbatch.pop("meta")
    assert_identical(jbatch, tbatch)

    jspec = jzoo.get_model_spec(SPEC[0], 20, 4, SPEC[1])
    tspec = tzoo.get_model_spec(SPEC[0], 20, 4, SPEC[1])
    jmodel = jax_build(jspec)
    variables = jax_variables(jmodel, jbatch, seed=2, train=False)
    opt = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4,
               grad_clip=10.0)
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jt.f32_convs():
            state = jstep.TrainState.create(
                jax.tree_util.tree_map(jnp.asarray, variables),
                jopt.make_optimizer(jopt.make_schedule("constant", 0.1),
                                    **opt))
            _, jm = jax.jit(jstep.make_train_step(jmodel))(
                state, jbatch, jax.random.PRNGKey(0))
        tmodel = build_model(tspec, device="cpu", seed=None)
        load_flax_variables(tmodel, variables)
        tstate = tstep.TrainState.create(tmodel, topt.make_optimizer(
            topt.make_schedule("constant", 0.1), **opt))
        with tt.f32_convs():
            _, tm = tstep.make_train_step(tmodel)(
                tstate, tcollate.batch_to_torch(tbatch, "cpu"), None)
    ref, got = float(jm["loss"]), float(tm["loss"])
    assert np.isfinite(got) and got > 0
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-3)


# --- the CLI ------------------------------------------------------------------

def test_cli_trains_and_writes_a_submission(layout, tmp_path, capsys):
    """``cli.train`` with the ScanNet recipe's config on the layout (a
    small model, 64 x 48 frames through ``data.kwargs``, as the JAX CLI
    passes them), then ``cli.eval --voting_runs 2 --submission``: one
    ``<scan>.txt`` per val scan, one NYU40 benchmark id per cached voxel;
    ``data.dataset=kitti360`` is not refused any more: on this ScanNet
    layout its loader finds no KITTI-360 window."""
    root = str(tmp_path / "raw")
    shutil.copytree(layout, root, symlinks=True,
                    ignore=shutil.ignore_patterns("processed_dva"))
    run = tmp_path / "run"
    metrics = cli_train.main([
        "--config", CONF, "--device", "cpu", f"data.root={root}",
        f"training.run_dir={run}", "training.epochs=1",
        "training.eval_frequency=1", "training.tensorboard=false",
        "model.name=Res16UNet14-L1-early-group2",
        "model.overrides={backbone: Res16UNetTest}", "data.voxel_size=0.1",
        "data.batch_size=2", "data.image_slots=2",
        "data.image_size=[64, 48]",
        "data.kwargs={radius: 1.5, samples_per_epoch: 4, frame_step: 2, "
        "image_size: [64, 48]}"])
    assert np.isfinite(metrics["val_miou"])
    stored = json.loads((run / "run.json").read_text())
    assert stored["data"]["dataset"] == "scannet"
    caches = sorted(f for f in os.listdir(os.path.join(root, "processed_dva"))
                    if f.endswith(".npz"))
    assert caches == [f"{s}.npz" for s in SCANNET_SCANS]
    capsys.readouterr()
    sub = tmp_path / "submission"
    out = cli_eval.main(["--run_dir", str(run), "--device", "cpu",
                         "--voting_runs", "2", "--submission", str(sub)])
    printed = capsys.readouterr().out
    assert "voting run 1:" in printed and f"submission: {sub}" in printed
    assert sorted(os.listdir(sub)) == [f"{SCANNET_SCANS[-1]}.txt"]
    ids = np.loadtxt(sub / f"{SCANNET_SCANS[-1]}.txt", dtype=np.int64)
    cache = tbase.load_area(os.path.join(root, "processed_dva",
                                         f"{SCANNET_SCANS[-1]}.npz"))
    assert ids.shape == (len(cache["pos"]),)
    assert set(ids.tolist()) <= set(ts.VALID_CLASS_IDS)
    for key in ("test_miou", "vote_miou"):
        assert np.isfinite(out[key]), key
    cfg = trun.load_run_config(None, ["data.dataset=kitti360",
                                      "data.kwargs={}"], base=stored)
    with pytest.raises(FileNotFoundError, match="no KITTI-360 windows"):
        cli_train.build_dataset(cfg, train=True, device="cpu")
