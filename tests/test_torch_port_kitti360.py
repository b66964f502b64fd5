"""The KITTI-360 loader of the PyTorch port against the JAX package, on a
miniature KITTI-360 release layout (``torch_port_util.fake_kitti360_layout``:
one sequence, three overlapping street windows with the release's extra PLY
fields, cam0 pinhole frames of 352 x 94 and cam2 / cam3 fisheye frames of
140 x 140 written by the port's ``write_png``, read at 176 x 47 and 70 x 70;
the release's calibration files, ``image_02.yaml`` in the release's form and
``image_03.yaml`` in the JAX test fixture's).

The readers, the cameras of both families, the window's PLY, the voxel grid,
the PNG decode and resize (the port's own, without PIL), the coverage
selection, the per-family non-static mask and the cylinder sampling are host
numpy: byte-identical to the JAX package.  The kNN, PCA and z-buffers run in
torch: normals and view features within 1e-4, every index array of the
mapping equal.  Samples of ``make_kitti360_dataset`` from one cache and one
seed are byte-identical, at train and at eval (the eval pixel credit priced
per camera family); ``cli.train.auto_bucket`` gives the JAX function's
``Bucket`` (one ladder bucket per camera family), both ``BatchLoader``s the
same family-ladder batch; ``write_submission`` writes the same zip members.
Then a CPU smoke of ``cli.train`` and ``cli.eval --voting_runs 2
--submission``."""

import dataclasses
import json
import os
import shutil
import warnings
import zipfile

import numpy as np
import pytest
import yaml

import train as jax_train_cli
from deepviewagg_tpu.config import run as jrun
from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import kitti360 as jk
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.data import collate as tcollate
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import kitti360 as tk
from torch_port_util import (KITTI360_FISHEYE_FIXTURE_YAML,  # noqa: F401
                             KITTI360_FISHEYE_YAML, KITTI360_SEQ,
                             KITTI360_WINDOWS, _torch_threads,
                             assert_identical, fake_kitti360_layout)

PRE = dict(voxel_size=0.25, image_size=(176, 47), fisheye_size=(70, 70),
           max_images=8)
HOST_KEYS = ("pos", "rgb", "labels", "origin_id", "images", "image_family",
             "family_sizes")
FEATS_ATOL = 1e-4
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf", "kitti360_benchmark.yaml")
WINDOWS = list(KITTI360_WINDOWS)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return fake_kitti360_layout(str(tmp_path_factory.mktemp("kitti360")
                                    / "raw"))


@pytest.fixture(scope="module")
def jax_caches(layout, tmp_path_factory):
    """``cache_dir`` of every window preprocessed by the JAX package."""
    out = str(tmp_path_factory.mktemp("jax_cache"))
    for w in WINDOWS:
        jk.preprocess_kitti360_window(layout, _ply(layout, w), out, **PRE)
    return out


def _ply(layout, window):
    return os.path.join(layout, "data_3d_semantics", KITTI360_SEQ, "static",
                        f"{window}.ply")


def _cache_name(window):
    start, end = (int(v) for v in window.split("_"))
    return f"{KITTI360_SEQ}_{start:010d}_{end:010d}.npz"


# --- tables and readers ---------------------------------------------------------

def test_tables_identical():
    assert tk.KITTI360_CLASSES == jk.KITTI360_CLASSES
    assert tk.NUM_CLASSES == jk.NUM_CLASSES == 19
    assert_identical(jk.ID2TRAINID, tk.ID2TRAINID)
    assert_identical(jk.TRAINID2ID, tk.TRAINID2ID)
    assert (tk.PERSP_SIZE, tk.FISHEYE_SIZE, tk.R_MIN, tk.R_MAX) == (
        jk.PERSP_SIZE, jk.FISHEYE_SIZE, jk.R_MIN, jk.R_MAX)
    assert tk.ID2TRAINID[26] == 13 and tk.TRAINID2ID[13] == 26


@pytest.mark.parametrize("text", [
    " 09-Jan-2012 14:00:15", " 1.408000e+03 3.760000e+02\n",
    " 552.55 0 682.05", " -1.5e-3 +2 .5 5.", " 1 2 3 ", " inf nan -inf",
    " 1,2", " 0x10 3", " 7E2 1e-300 2.5e+308", "1e+ 2", "1.5.5 2", "",
    "abc 1"])
def test_floats_read_as_fromstring(text):
    """The replacement of the deprecated ``np.fromstring(val, sep=" ")``:
    the same float64 values, the leading number of the first token that is
    not a whole number included."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.fromstring(text, sep=" ", dtype=np.float64)
    got = tk._floats(text)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", ["   \n", " abc 1"])
def test_floats_give_no_value_where_fromstring_gives_its_sentinel(text):
    """numpy reads ``[-1.]`` from a value of whitespace only or one that
    starts with a word after whitespace; the port reads no value."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert np.fromstring(text, sep=" ").tolist() == [-1.0]
    assert tk._floats(text).tolist() == []


def test_calibration_readers_identical(layout, tmp_path):
    """``perspective.txt`` (release form, ``calib_time`` line included),
    ``calib_cam_to_pose.txt``, ``cam0_to_world.txt``, ``poses.txt``; the
    missing ones read as the JAX functions read them."""
    calib = os.path.join(layout, "calibration")
    poses = os.path.join(layout, "data_poses", KITTI360_SEQ)
    got = tk.read_perspective_calib(os.path.join(calib, "perspective.txt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jk.read_perspective_calib(os.path.join(calib,
                                                      "perspective.txt"))
    assert_identical(want, got)
    assert got["calib_time"].tolist() == [9.0]
    assert got["P_rect_00"].shape == (12,)
    c2p = os.path.join(calib, "calib_cam_to_pose.txt")
    assert_identical(jk.read_cam_to_pose(c2p), tk.read_cam_to_pose(c2p))
    assert_identical(jk.read_cam0_to_world(os.path.join(
        poses, "cam0_to_world.txt")), tk.read_cam0_to_world(os.path.join(
            poses, "cam0_to_world.txt")))
    assert_identical(jk.read_imu_poses(os.path.join(poses, "poses.txt")),
                     tk.read_imu_poses(os.path.join(poses, "poses.txt")))
    missing = str(tmp_path / "none.txt")
    assert tk.read_cam_to_pose(missing) == jk.read_cam_to_pose(missing) == {}
    assert tk.read_imu_poses(missing) == jk.read_imu_poses(missing) == {}
    one = tmp_path / "one.txt"
    one.write_text("5 " + " ".join(["1.0"] * 16) + "\n")
    assert_identical(jk.read_cam0_to_world(str(one)),
                     tk.read_cam0_to_world(str(one)))


_FISHEYE_FORMS = {
    "release": KITTI360_FISHEYE_YAML,
    "fixture": KITTI360_FISHEYE_FIXTURE_YAML,
    "no_directive": KITTI360_FISHEYE_YAML.split("\n", 1)[1],
    "missing_key": KITTI360_FISHEYE_FIXTURE_YAML.replace("   k2: -0.01\n",
                                                         ""),
    "missing_group": KITTI360_FISHEYE_FIXTURE_YAML.split(
        "projection_parameters")[0],
    "empty": "%YAML:1.0\n---\n",
}


@pytest.mark.parametrize("form", sorted(_FISHEYE_FORMS))
def test_fisheye_calib_identical(tmp_path, form):
    """``read_fisheye_calib`` on the release's form, the JAX fixture's and
    broken ones: the JAX function's seven float32 values (it reads with
    PyYAML, which the card's machine lacks), ``None`` where a key is
    missing."""
    path = tmp_path / "image_02.yaml"
    path.write_text(_FISHEYE_FORMS[form])
    want, got = jk.read_fisheye_calib(str(path)), tk.read_fisheye_calib(
        str(path))
    if form.startswith(("missing", "empty")):
        assert want is None and got is None
        return
    assert_identical(want, got)
    text = "\n".join(line for line in _FISHEYE_FORMS[form].splitlines()
                     if not line.startswith("%"))
    d = yaml.safe_load(text)
    assert got.tolist() == np.array([
        d["mirror_parameters"]["xi"], d["distortion_parameters"]["k1"],
        d["distortion_parameters"]["k2"],
        *(d["projection_parameters"][k]
          for k in ("gamma1", "gamma2", "u0", "v0"))], np.float32).tolist()
    assert tk.read_fisheye_calib(str(tmp_path / "absent.yaml")) is None


@pytest.mark.parametrize("window", WINDOWS)
def test_window_cloud_identical(layout, window):
    """The window PLY (its ``instanceId``, ``isVisible`` and ``confidence``
    skipped), ids -> train ids (0, unlabelled, reads -1); the key."""
    p = _ply(layout, window)
    ref, got = jk.load_window_cloud(p), tk.load_window_cloud(p)
    assert_identical(ref, got)
    assert -1 in got[2] and {0, 1, 2, 8, 13} <= set(got[2].tolist())
    assert got[1].max() <= 1.0
    assert tk._window_key(p) == jk._window_key(p) == (
        KITTI360_SEQ, *(int(v) for v in window.split("_")))


def test_window_cloud_without_semantic_or_8bit_colours(tmp_path):
    from deepviewagg_tpu_torch.utils.ply import write_ply

    rng = np.random.default_rng(0)
    p = str(tmp_path / "0000000000_0000000010.ply")
    write_ply(p, {"x": rng.normal(size=20).astype(np.float32),
                  "y": rng.normal(size=20).astype(np.float32),
                  "z": rng.normal(size=20).astype(np.float32),
                  "red": rng.uniform(0, 1, 20).astype(np.float32),
                  "green": rng.uniform(0, 1, 20).astype(np.float32),
                  "blue": rng.uniform(0, 1, 20).astype(np.float32)})
    ref, got = jk.load_window_cloud(p), tk.load_window_cloud(p)
    assert_identical(ref, got)
    assert (got[2] == -1).all()
    assert tk._window_key(p) == jk._window_key(p) == ("seq", 0, 10)


def _camera_lists_equal(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a["path"] == b["path"]
        for f in dataclasses.fields(a["camera"]):
            assert_identical(getattr(a["camera"], f.name),
                             getattr(b["camera"], f.name), f.name)


@pytest.mark.parametrize("step", [10, 20])
@pytest.mark.parametrize("size", ["recipe", "small"])
def test_cameras_identical(layout, step, size):
    """Both families' cameras of a window: frames by ``frame_step`` and by
    the PNG's existence (no cam3 frame 50), poses and intrinsics rescaled
    to the bucket size (the fisheye's affine MEI part by ``[1, 1, 1, sx,
    sy, sx, sy]``), ``poses[frame] @ c2p`` in float32."""
    pin, fe = ((704, 188), (350, 350)) if size == "recipe" else (
        (176, 47), (70, 70))
    ref = jk.window_cameras(layout, KITTI360_SEQ, 30, 70, pin, step)
    got = tk.window_cameras(layout, KITTI360_SEQ, 30, 70, pin, step)
    _camera_lists_equal(ref, got)
    assert len(got) == (5 if step == 10 else 2)
    ref = jk.fisheye_cameras(layout, KITTI360_SEQ, 30, 70, fe, step)
    got = tk.fisheye_cameras(layout, KITTI360_SEQ, 30, 70, fe, step)
    _camera_lists_equal(ref, got)
    assert len(got) == (9 if step == 10 else 4)
    assert got[0]["camera"].extrinsic.dtype == np.float32
    assert got[0]["camera"].fisheye[3] == pytest.approx(
        1.3363220825849971e+03 * fe[0] / 1400, rel=1e-6)
    assert tk.window_cameras(layout, "2013_05_28_drive_0009_sync", 0,
                             100) == []


def _mapping_fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("kw,n_images", [
    ({}, 8), (dict(use_fisheye=False, max_images=3), 3),
    (dict(max_images=None), 14), (dict(exact_splatting=True, n_sample=2), 8)],
    ids=["recipe", "pinhole_only", "all_images", "exact"])
def test_preprocess_matches_jax(layout, tmp_path, kw, n_images):
    """The window cache of both packages: the host arrays (images, the
    camera family of each and the family sizes included) byte-identical;
    normals and view features within ``FEATS_ATOL``; every mapping index
    array equal (the per-family non-static mask dropped the same
    pixels)."""
    pre = {**PRE, **kw}
    jp = jk.preprocess_kitti360_window(layout, _ply(layout, WINDOWS[1]),
                                       str(tmp_path / "j"), **pre)
    tp = tk.preprocess_kitti360_window(layout, _ply(layout, WINDOWS[1]),
                                       str(tmp_path / "t"), device="cpu",
                                       **pre)
    assert os.path.basename(tp) == _cache_name(WINDOWS[1])
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
    fam = got["image_family"]
    assert m.num_images == len(got["images"]) == len(fam) == n_images
    sizes = got["family_sizes"].tolist()
    assert sizes == ([[176, 47]] if kw.get("use_fisheye") is False
                     else [[176, 47], [70, 70]])
    assert got["images"].shape[1:] == (176, 47 if len(sizes) == 1 else 70, 3)
    if len(sizes) == 2:
        assert set(fam.tolist()) == {0, 1}
        # each frame at the canvas origin: nothing outside its family's size
        assert not got["images"][fam == 0][:, :, 47:].any()
        assert not got["images"][fam == 1][:, 70:].any()
        pv = np.minimum(m.pix_view, m.view_capacity - 1)
        pf = fam[m.image_id[pv]]
        fe = m.pix_valid & (pf == 1)
        assert fe.any() and m.pix_x[fe].max() < 70 and m.pix_y[fe].max() < 70
        # the vehicle's body (the fisheyes' bottom 12 of 140 rows; the
        # bottom 5 of 70 after the resize) is static
        assert not (fe & (m.pix_y >= 70 - 5)).any()
    assert m.pix_valid.sum() > 500
    assert tk.preprocess_kitti360_window(
        layout, _ply(layout, WINDOWS[1]), str(tmp_path / "t"),
        device="cpu", **pre) == tp


# --- datasets ----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dataset_samples_identical(layout, jax_caches, train):
    """``make_kitti360_dataset`` of both packages on the JAX package's
    caches: the split lists under ``data_3d_semantics/train/`` pick the
    windows, cylinders, the S3DIS augmentation chain and the recipe's
    colour jitter at train, the eval pixel credit priced per camera family;
    byte-identical samples."""
    kw = dict(train=train, radius=4.0, image_slots=2, samples_per_epoch=6,
              cache_dir=jax_caches, **PRE)
    jds = jk.make_kitti360_dataset(layout, **kw)
    tds = tk.make_kitti360_dataset(layout, device="cpu", **kw)
    want = [w for w, sp in KITTI360_WINDOWS.items()
            if (sp == "train") == train]
    assert tds.areas.paths == jds.areas.paths == [
        os.path.join(jax_caches, _cache_name(w)) for w in want]
    for field in ("radius", "voxel_size", "num_classes", "train",
                  "image_slots", "samples_per_epoch", "color_jitter",
                  "select_shape", "image_families"):
        assert getattr(tds, field) == getattr(jds, field), field
    assert tds.image_families == [(176, 47), (70, 70)]
    assert tds.select_shape == "cylinder"
    assert tds.color_jitter == ((0.2, 0.2, 0.2) if train else None)
    assert len(jds) == len(tds) > 1
    families = set()
    for i in range(len(jds)):
        ref, got = jds[i], tds[i]
        if ref is None:
            assert got is None
            continue
        assert_identical(ref, got)
        if got.image_family is not None:
            families |= set(np.asarray(got.image_family).tolist())
            assert len(got.image_family) <= 2 or not train
    assert families == {0, 1}


def test_eval_credit_prices_each_family(layout, jax_caches):
    """At eval the pixel budget is ``image_slots`` pinhole frames and each
    image costs its family's size: with one slot a pinhole frame (8,272
    pixels) and a fisheye (4,900) cannot both be kept, two fisheyes can."""
    kw = dict(train=False, radius=4.0, image_slots=1, cache_dir=jax_caches,
              **PRE)
    jds = jk.make_kitti360_dataset(layout, **kw)
    tds = tk.make_kitti360_dataset(layout, device="cpu", **kw)
    kept = set()
    for i in range(len(tds)):
        ref, got = jds[i], tds[i]
        assert_identical(ref, got)
        if got is not None and got.image_family is not None:
            fam = np.asarray(got.image_family)
            px = np.where(fam == 0, 176 * 47, 70 * 70).sum()
            assert px <= 176 * 47
            kept.add(tuple(sorted(fam.tolist())))
    assert kept and kept <= {(0,), (1,)}


def test_split_lists_and_the_90_10_split(layout, jax_caches, tmp_path):
    """The lists directly under ``data_3d_semantics/`` are read too; without
    lists every tenth window (the first of three) is val, with the JAX
    package's warning; a root without windows raises."""
    root = str(tmp_path / "raw")
    shutil.copytree(layout, root, symlinks=True,
                    ignore=shutil.ignore_patterns("processed_dva"))
    lists = os.path.join(root, "data_3d_semantics")
    for split in ("train", "val"):
        os.rename(os.path.join(lists, "train", f"2013_05_28_drive_{split}.txt"),
                  os.path.join(lists, f"2013_05_28_drive_{split}.txt"))
    kw = dict(cache_dir=jax_caches, **PRE)
    for train in (True, False):
        jds = jk.make_kitti360_dataset(root, train=train, **kw)
        tds = tk.make_kitti360_dataset(root, train=train, device="cpu", **kw)
        assert tds.areas.paths == jds.areas.paths
    for split in ("train", "val"):
        os.remove(os.path.join(lists, f"2013_05_28_drive_{split}.txt"))
    for train in (True, False):
        with pytest.warns(UserWarning, match="90/10"):
            jds = jk.make_kitti360_dataset(root, train=train, **kw)
        with pytest.warns(UserWarning, match="90/10"):
            tds = tk.make_kitti360_dataset(root, train=train, device="cpu",
                                           **kw)
        want = WINDOWS[1:] if train else WINDOWS[:1]
        assert tds.areas.paths == jds.areas.paths == [
            os.path.join(jax_caches, _cache_name(w)) for w in want]
    with pytest.raises(FileNotFoundError, match="no KITTI-360 windows"):
        tk.make_kitti360_dataset(root, train=True, device="cpu",
                                 sequences=["2013_05_28_drive_0009_sync"],
                                 **kw)


def test_mapping_params_drop_like_jax(layout, jax_caches):
    mp = dict(crop_padding=4, proj_upscale=2, density=True, occlusion=True,
              exact=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tds = tk.make_kitti360_dataset(layout, train=False,
                                       cache_dir=jax_caches, device="cpu",
                                       mapping_params=mp, **PRE)
    assert tds.areas.paths == [os.path.join(jax_caches,
                                            _cache_name(WINDOWS[-1]))]


def _cfg(pkg, layout, cache, **data):
    overrides = [f"data.root={layout}", "data.dataset=kitti360",
                 "data.radius=4.0", "data.batch_size=2",
                 "data.image_slots=2", "data.samples_per_epoch=6",
                 "data.voxel_size=0.25", "data.image_size=[176, 47]",
                 "data.kwargs={image_size: [176, 47], fisheye_size: [70, 70],"
                 f" max_images: 8, cache_dir: {cache}}}"]
    overrides += [f"data.{k}={v}" for k, v in data.items()]
    return pkg.load_run_config(CONF, overrides)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_auto_bucket_and_family_ladder_batch_identical(layout, jax_caches,
                                                       train):
    """``cli.train.auto_bucket`` on the KITTI-360 dataset: one ladder bucket
    per camera family (each image's bucket its family, at the canvas
    origin), the caps and ladder caps of the JAX function; both
    ``BatchLoader``s collate the same first batch, both families' buckets
    holding images."""
    jcfg = _cfg(jrun, layout, jax_caches)
    tcfg = _cfg(trun, layout, jax_caches)
    jds = jax_train_cli.build_dataset(jcfg, train=train)
    tds = cli_train.build_dataset(tcfg, train=train, device="cpu")
    jb = jax_train_cli.auto_bucket(jcfg, jds, [0])
    tb = cli_train.auto_bucket(tcfg, tds, [0])
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert tb.image_ladder == [(176, 47), (70, 70)]
    assert len(tb.ladder_pix_caps) == len(tb.ladder_image_caps) == 2
    jbatches = list(jbase.BatchLoader(jds, jcollate.Bucket(
        **dataclasses.asdict(jb)), 2, [0], shuffle=train, seed=1))
    tbatches = list(tbase.BatchLoader(tds, tcollate.Bucket(
        **dataclasses.asdict(tb)), 2, [0], shuffle=train, seed=1))
    assert len(jbatches) == len(tbatches) > 1
    both = 0
    for jbatch, tbatch in zip(jbatches, tbatches):
        jbatch.pop("meta"), tbatch.pop("meta")
        assert_identical(jbatch, tbatch)
        assert "images" not in tbatch
        assert [im.shape[1:3] for im in tbatch["bucket_images"]] == [
            (176, 47), (70, 70)]
        buckets = tbatch["mappings"][0]["buckets"]
        both += all(b["pix_valid"].any() for b in buckets)
        fe = buckets[1]
        assert fe["pix_x"][fe["pix_valid"]].max(initial=0) < 70
        assert fe["pix_y"][fe["pix_valid"]].max(initial=0) < 70
    assert both


def test_write_submission_identical(tmp_path):
    rng = np.random.default_rng(0)
    preds = {f"{KITTI360_SEQ}_{w}": rng.integers(-1, 22, 40 + 9 * i)
             for i, w in enumerate(("0000000000_0000000040",
                                    "0000000060_0000000100"))}
    a = jk.write_submission(str(tmp_path / "j"), preds)
    b = tk.write_submission(str(tmp_path / "t"), preds)
    assert os.path.basename(b) == "submission.zip"
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist() == [f"{n}.npy" for n in preds]
        for name in za.namelist():
            assert za.read(name) == zb.read(name)
            ids = np.load(zb.open(name))
            assert ids.dtype == np.uint8
            assert set(ids.tolist()) <= set(tk.TRAINID2ID.tolist())


# --- the CLI ------------------------------------------------------------------

def test_cli_trains_and_writes_a_submission(layout, tmp_path, capsys):
    """``cli.train`` with the KITTI-360 recipe's config on the layout (a
    small model in place of the five-tower recipe, small sizes through
    ``data.*`` and ``data.kwargs`` as the JAX CLI passes them), then
    ``cli.eval --voting_runs 2 --submission``: ``submission.zip`` with one
    ``.npy`` of original ids per val window, one per cached voxel."""
    root = str(tmp_path / "raw")
    shutil.copytree(layout, root, symlinks=True,
                    ignore=shutil.ignore_patterns("processed_dva"))
    run = tmp_path / "run"
    metrics = cli_train.main([
        "--config", CONF, "--device", "cpu", f"data.root={root}",
        f"training.run_dir={run}", "training.epochs=1",
        "training.eval_frequency=1", "training.tensorboard=false",
        "model.name=Res16UNet14-L1-early-group2",
        "model.overrides={backbone: Res16UNetTest}", "data.voxel_size=0.25",
        "data.radius=4.0", "data.batch_size=2", "data.image_slots=2",
        "data.samples_per_epoch=4", "data.image_size=[176, 47]",
        "data.kwargs={image_size: [176, 47], fisheye_size: [70, 70], "
        "max_images: 8}"])
    printed = capsys.readouterr().out
    assert np.isfinite(metrics["val_miou"])
    stored = json.loads((run / "run.json").read_text())
    assert stored["data"]["dataset"] == "kitti360"
    caches = sorted(f for f in os.listdir(os.path.join(root, "processed_dva"))
                    if f.endswith(".npz"))
    assert caches == sorted(_cache_name(w) for w in WINDOWS)
    assert "bucket:" in printed
    sub = tmp_path / "submission"
    out = cli_eval.main(["--run_dir", str(run), "--device", "cpu",
                         "--voting_runs", "2", "--submission", str(sub)])
    printed = capsys.readouterr().out
    assert "voting run 1:" in printed
    assert f"submission: {sub / 'submission.zip'}" in printed
    val = [w for w, sp in KITTI360_WINDOWS.items() if sp == "val"]
    name = _cache_name(val[0])[:-4]
    with zipfile.ZipFile(sub / "submission.zip") as z:
        assert z.namelist() == [f"{name}.npy"]
        ids = np.load(z.open(f"{name}.npy"))
    cache = tbase.load_area(os.path.join(root, "processed_dva",
                                         f"{name}.npz"))
    assert ids.shape == (len(cache["pos"]),) and ids.dtype == np.uint8
    assert set(ids.tolist()) <= set(tk.TRAINID2ID.tolist())
    for key in ("test_miou", "vote_miou"):
        assert np.isfinite(out[key]), key
