"""The Biasutti and depth-map visibility methods and the mapping factory's
three methods, the port against the JAX package on the CPU.

``biasutti_visibility`` (with and without the panorama X-wrap) and
``depth_map_visibility`` take the same float32 projection in both packages
and give equal masks; ``build_mappings`` builds equal index arrays for
``splatting``, ``biasutti`` and ``depth`` over ScanNet cameras and
panoramas, the view features within 1e-4 (the PCA features' kNN and
eigensolver differ in float32 rounding: 5e-5 measured).  On the card the
kNN may order exact distance ties apart (``ops/knn.py``), which can move a
point across the mean-alpha threshold: ``chip_smoke.py`` 4c holds that
card-vs-CPU share."""

import dataclasses

import numpy as np
import pytest
import torch

from deepviewagg_tpu.core import cameras as jc
from deepviewagg_tpu.core import visibility as jv
from deepviewagg_tpu.data import mapping_factory as jmf
from deepviewagg_tpu_torch.core import cameras as tc
from deepviewagg_tpu_torch.core import visibility as tv
from deepviewagg_tpu_torch.data import mapping_factory as tmf
from deepviewagg_tpu_torch.data import synthetic
from torch_port_util import (CAMERA_MODELS, _torch_threads,  # noqa: F401
                             assert_identical, camera_fields, camera_scene)

FEATS_ATOL = 1e-4


@pytest.fixture(scope="module")
def pos():
    return camera_scene()


def _projection(pos, model):
    f = camera_fields(model)
    jcam = jc.Camera(**f)
    x, y, d, v = (np.array(a) for a in jc.project(pos, jcam))
    return f, jcam, (x, y, d, v)


@pytest.mark.parametrize("margin", [None, 10.0], ids=["plain", "x_wrap"])
@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_biasutti_matches_jax(pos, model, margin):
    """The mean-alpha threshold over 20 projected neighbours; with
    ``x_margin`` the border points also search across the seam."""
    f, _, proj = _projection(pos, model)
    ref = np.asarray(jv.biasutti_visibility(
        *proj, k=20, x_margin=margin, x_width=f["size"][0]))
    got = tv.biasutti_visibility(*(torch.from_numpy(a) for a in proj), k=20,
                                 x_margin=margin, x_width=f["size"][0])
    assert got.dtype == torch.bool
    assert np.array_equal(ref, got.numpy())
    valid = proj[3]
    assert 0 < got.sum() < valid.sum()
    assert not got.numpy()[~valid].any()


def test_biasutti_x_wrap_changes_border_points(pos):
    """On the panorama the wrap changes some points' verdicts."""
    f, _, proj = _projection(pos, "s3dis_equirectangular")
    t = [torch.from_numpy(a) for a in proj]
    plain = tv.biasutti_visibility(*t, k=20).numpy()
    wrapped = tv.biasutti_visibility(*t, k=20, x_margin=10.0,
                                     x_width=f["size"][0]).numpy()
    assert (plain != wrapped).any()


@pytest.mark.parametrize("threshold", [0.3, 0.9])
def test_biasutti_fixed_threshold_matches_jax(pos, threshold):
    _, _, proj = _projection(pos, "scannet")
    ref = np.asarray(jv.biasutti_visibility(*proj, k=12, threshold=threshold))
    got = tv.biasutti_visibility(*(torch.from_numpy(a) for a in proj), k=12,
                                 threshold=threshold).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_depth_map_visibility_matches_jax(pos, model):
    """Against the splat z-buffer's own depth map: the points within 5 cm
    of the depth at their pixel."""
    f, jcam, (x, y, d, v) = _projection(pos, model)
    depth = np.array(jv.splat_zbuffer(jcam, pos, voxel=0.05)[1])
    ref = np.asarray(jv.depth_map_visibility(x, y, d, depth))
    got = tv.depth_map_visibility(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(d), depth).numpy()
    assert np.array_equal(ref, got)
    assert 0 < (got & v).sum() < v.sum()


def test_project_features_matches_jax(pos):
    f, jcam, _ = _projection(pos, "kitti360_fisheye")
    tcam = tc.Camera(**f)
    ref = jv.project_features(jcam, pos)
    got = tv.project_features(tcam, torch.from_numpy(pos))
    assert ref[4] is None and got[4] is None
    assert np.array_equal(np.asarray(ref[3]), got[3].numpy())
    assert np.abs(np.asarray(ref[0]) - got[0].numpy())[got[3].numpy()].max() \
        <= 1e-4


def test_orientation_to_normal_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(50, 3)).astype(np.float32) for _ in range(2))
    assert np.abs(np.asarray(jv.orientation_to_normal(a, b)) - (
        tv.orientation_to_normal(torch.from_numpy(a), torch.from_numpy(b))
        .numpy())).max() <= 1e-6


def _scene_cameras(model):
    base = "scannet" if model != "s3dis_equirectangular" else model
    scene = synthetic.make_scene(seed=3, density=40.0, n_cameras=3,
                                 image_size=(96, 64), camera_model=base)
    cams = [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
            for c in scene.cameras]
    return scene.pos, cams


@pytest.mark.parametrize("method", ["splatting", "biasutti", "depth"])
@pytest.mark.parametrize("model", ["scannet", "s3dis_equirectangular"])
def test_build_mappings_matches_jax(model, method):
    """Every index array of the mapping equal, the view features within
    ``FEATS_ATOL``; the non-splatting methods map one centre pixel per
    seen point (the depth method against the splat z-buffers' depth
    maps)."""
    pos, cams = _scene_cameras(model)
    jcams = [jc.Camera(**c) for c in cams]
    depth_maps = None
    if method == "depth":
        depth_maps = [np.array(jv.splat_zbuffer(c, pos, voxel=0.1)[1])
                      for c in jcams]
    kw = dict(voxel=0.1, method=method, biasutti_k=20,
              biasutti_margin=8.0 if model != "scannet" else None)
    ref = jmf.build_mappings(pos, jcams, jmf.VisibilityParams(**kw),
                             depth_maps=depth_maps)
    got = tmf.build_mappings(pos, [tc.Camera(**c) for c in cams],
                             tmf.VisibilityParams(**kw),
                             depth_maps=depth_maps, device="cpu")
    got.check()
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "view_feats":
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= FEATS_ATOL
        else:
            assert_identical(a, b, f.name)
    assert got.num_views > 100
    if method != "splatting":
        assert got.num_pixels == got.num_views
    else:
        assert got.num_pixels > got.num_views


def test_depth_method_needs_depth_maps():
    pos, cams = _scene_cameras("scannet")
    for mf, camera in ((jmf, jc.Camera), (tmf, tc.Camera)):
        kwargs = {} if mf is jmf else {"device": "cpu"}
        with pytest.raises(ValueError, match="depth_maps"):
            mf.build_mappings(pos, [camera(**c) for c in cams],
                              mf.VisibilityParams(method="depth"), **kwargs)
    with pytest.raises(AssertionError):
        tmf.VisibilityParams(method="nearest")


def test_visibility_params_match_jax():
    assert vars(tmf.VisibilityParams()) == vars(jmf.VisibilityParams())
    kw = dict(method="biasutti", biasutti_k=9, biasutti_margin=4.0,
              biasutti_threshold=0.5, depth_threshold=0.1, knn_k=8)
    assert vars(tmf.VisibilityParams(**kw)) == vars(
        jmf.VisibilityParams(**kw))
