"""The port's four camera models against the JAX package, on the CPU: the
equirectangular panorama, the ScanNet and KITTI-360 pinholes and the MEI
fisheye (``torch_port_util.camera_fields``), over one synthetic room.

Both packages compute the same float32 formulas; XLA and ATen order some
sums differently (the 3 x 3 products, the 4 x 4 inverse of the ScanNet
pose: LAPACK in both here, cuSOLVER on the card), so pixel coordinates
agree to ``PIX_ATOL`` (measured: 3.4e-5 px at most), not bit for bit.  The
splat boxes, taken from the same projection, are equal integers; the
z-buffers' winner and depth maps are equal on every pixel of these
scenes, and the validity masks equal."""

import dataclasses

import numpy as np
import pytest
import torch

from deepviewagg_tpu.core import cameras as jc
from deepviewagg_tpu.core import visibility as jv
from deepviewagg_tpu_torch.core import cameras as tc
from deepviewagg_tpu_torch.core import visibility as tv
from torch_port_util import (CAMERA_MODELS, _torch_threads,  # noqa: F401
                             camera_fields, camera_scene)

PIX_ATOL = 1e-4         # pixels; float32 rounding of reordered sums
DIST_ATOL = 1e-6        # metres


@pytest.fixture(scope="module")
def pos():
    return camera_scene()


def _cameras(model, **changes):
    fields = {**camera_fields(model), **changes}
    return jc.Camera(**fields), tc.Camera(**fields)


def _project(pos, jcam, tcam):
    ref = [np.asarray(a) for a in jc.project(pos, jcam)]
    got = [a.numpy() for a in tc.project(torch.from_numpy(pos), tcam)]
    return ref, got


def test_camera_models_are_the_jax_ones():
    assert tc.CAMERA_MODELS == jc.CAMERA_MODELS == CAMERA_MODELS
    assert [f.name for f in dataclasses.fields(tc.Camera)] == [
        f.name for f in dataclasses.fields(jc.Camera)]


@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_project_matches_jax(pos, model):
    """Pixel coordinates within ``PIX_ATOL``, distances within
    ``DIST_ATOL``, the validity mask equal; the camera sees part of the
    room."""
    jcam, tcam = _cameras(model)
    (jx, jy, jd, jvalid), (tx, ty, td, tvalid) = _project(pos, jcam, tcam)
    assert np.array_equal(jvalid, tvalid)
    assert 0.1 * len(pos) < tvalid.sum() <= len(pos)
    assert np.abs(jx - tx)[jvalid].max() <= PIX_ATOL
    assert np.abs(jy - ty)[jvalid].max() <= PIX_ATOL
    assert np.abs(jd - td).max() <= DIST_ATOL
    assert tx.dtype == ty.dtype == td.dtype == np.float32


@pytest.mark.parametrize("model", ["scannet", "kitti360_perspective"])
def test_pinhole_clamps_depth_at_the_camera_plane(model):
    """A point on the camera plane (``|z| < 1e-8``) divides by 1e-8, as
    in the JAX package; the raw camera z is returned.  An axis-aligned pose
    with integer translation, so that both z come out exactly 0."""
    fields = camera_fields(model)
    e = np.eye(4, dtype=np.float32)
    e[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]    # looks along +x
    e[:3, 3] = [1, 2, 1]
    # one point on the camera's x axis (z = 0), one 2 m in front of it
    pts = (e[:3, 3] + np.stack([e[:3, 0], 2 * e[:3, 2]])).astype(np.float32)
    ref = jc.pinhole_projection(pts, e, fields["intrinsic"], model=model)
    got = tc.pinhole_projection(torch.from_numpy(pts), e, fields["intrinsic"],
                                model=model)
    for a, b in zip(ref, got):
        assert np.allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=PIX_ATOL)
    assert float(got[2][0]) == 0.0 and float(got[2][1]) == 2.0
    assert abs(float(got[0][0])) > 1e9          # 1 / 1e-8 scaled


def test_fisheye_projection_matches_jax(pos):
    """The MEI model alone, in front of and behind the camera (the output
    depth keeps the sign of the camera z)."""
    fields = camera_fields("kitti360_fisheye")
    ref = jc.fisheye_projection(pos, fields["extrinsic"], fields["fisheye"])
    got = tc.fisheye_projection(torch.from_numpy(pos), fields["extrinsic"],
                                fields["fisheye"])
    for a, b in zip(ref, got):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= PIX_ATOL
    assert (got[2] < 0).any() and (got[2] > 0).any()


@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_splat_bboxes_match_jax(pos, model):
    """From the same projection, the integer splat boxes are equal (the
    fisheye's re-projects the voxel's top inside)."""
    jcam, tcam = _cameras(model)
    x, y, d, _ = (np.array(a) for a in jc.project(pos, jcam))
    ref = jv.splat_bboxes(jcam, pos, x, y, d, voxel=0.05, k_swell=1.5)
    got = tv.splat_bboxes(tcam, torch.from_numpy(pos), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(d),
                          voxel=0.05, k_swell=1.5)
    for a, b in zip(ref, got):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())
    widths = (got[1] - got[0]).numpy()
    assert widths.min() >= 1 and widths.max() > 1


@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_field_of_view_mask_honours_camera_mask(pos, model):
    """A static-pixel ``Camera.mask`` ``[W, H]`` drops the points whose
    floor pixel it masks, indexed ``[x, y]`` as in the JAX package."""
    size = camera_fields(model)["size"]
    mask = np.random.default_rng(3).random(size) < 0.7
    jcam, tcam = _cameras(model, mask=mask)
    (_, _, _, jvalid), (tx, ty, _, tvalid) = _project(pos, jcam, tcam)
    assert np.array_equal(jvalid, tvalid)
    _, unmasked = _cameras(model)
    free = tc.project(torch.from_numpy(pos), unmasked)[3].numpy()
    xi = np.floor(tx[free]).astype(int)
    yi = np.floor(ty[free]).astype(int)
    assert np.array_equal(tvalid[free], mask[xi, yi])
    assert 0 < tvalid.sum() < free.sum()


@pytest.mark.parametrize("exact", [False, True], ids=["splat", "exact"])
@pytest.mark.parametrize("model", CAMERA_MODELS)
def test_splat_zbuffer_maps_match_jax(pos, model, exact):
    """One camera's z-buffer: the winner map and the depth map equal on
    every pixel; the projection outputs as above."""
    jcam, tcam = _cameras(model)
    ref = jv.splat_zbuffer(jcam, pos, voxel=0.05, exact=exact)
    got = tv.splat_zbuffer(tcam, torch.from_numpy(pos), voxel=0.05,
                           exact=exact)
    assert len(got) == len(ref) == 6
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    idx, depth = got[0].numpy(), got[1].numpy()
    assert idx.shape == tuple(tcam.size)
    assert np.array_equal(np.asarray(ref[0]), idx)
    assert np.array_equal(np.asarray(ref[1]), depth)
    seen = idx >= 0
    assert seen.sum() > 100
    assert np.array_equal(depth < 0, ~seen)
    assert np.array_equal(np.asarray(ref[5]), got[5].numpy())


def test_splat_zbuffer_features_match_jax(pos):
    """``geo`` adds the six viewing-condition features of every point."""
    from deepviewagg_tpu.data.geometric import pca_features as jpca

    geo = {k: np.asarray(v) for k, v in jpca(pos, k=16).items()
           if k in ("linearity", "planarity", "scattering", "normal")}
    jcam, tcam = _cameras("scannet")
    ref = jv.splat_zbuffer(jcam, pos, voxel=0.05, geo=geo)[6]
    got = tv.splat_zbuffer(tcam, torch.from_numpy(pos), voxel=0.05,
                           geo={k: torch.from_numpy(v)
                                for k, v in geo.items()})[6]
    valid = np.asarray(jc.project(pos, jcam)[3])
    assert got.shape == (len(pos), 6)
    # points behind the camera have huge pixel heights: held where valid
    assert np.abs(np.asarray(ref) - got.numpy())[valid].max() <= 1e-5
