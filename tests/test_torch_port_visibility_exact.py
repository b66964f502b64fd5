"""Exact splatting of the PyTorch port against the JAX package.

``exact=True`` keeps only the splat z-buffer's winning points, each at its
centre projection pixel.  Where the centres of several winners share a
pixel, the JAX package's ``.at[pix].set(arange(n))`` keeps the last writer
on the CPU — the largest point index — and the port's
``scatter_reduce_("amax")`` keeps the same one in any order.  The cases
below are built so that centres collide."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.core import cameras as jcam
from deepviewagg_tpu.core import visibility as jvis
from deepviewagg_tpu.data import synthetic as jsyn
from deepviewagg_tpu.ops import voxel as jvox
from deepviewagg_tpu_torch.core import cameras as tcam
from deepviewagg_tpu_torch.core import visibility as tvis
from torch_port_util import _torch_threads  # noqa: F401

SIZE = (128, 64)


def _camera(size=SIZE):
    return jcam.Camera(model="s3dis_equirectangular", size=size,
                      pos=np.zeros(3, np.float32),
                      opk=np.zeros(3, np.float32), r_min=0.1, r_max=30.0)


def _torch_camera(cam):
    return tcam.Camera(**{f.name: getattr(cam, f.name)
                          for f in dataclasses.fields(cam)})


def _patch(seed, n=400):
    """A dense patch of points at 1.5-2.5 m, so that many seen points share
    a centre pixel at 128 x 64."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.5, 2.5, n)
    az = rng.uniform(-0.4, 0.4, n)
    el = rng.uniform(-0.3, 0.3, n)
    return np.stack([d * np.cos(el) * np.cos(az), d * np.cos(el) * np.sin(az),
                     d * np.sin(el)], axis=1).astype(np.float32)


def _jax_exact(cam, pos, voxel, max_splat):
    return np.asarray(jvis.splat_zbuffer_batch(
        [cam], jnp.asarray(pos), voxel=voxel, exact=True,
        max_splat=max_splat)[0])[0]


def _torch_exact(cam, pos, voxel, max_splat, exact=True):
    return tvis.splat_zbuffer_batch(
        [_torch_camera(cam)], torch.from_numpy(pos), voxel=voxel,
        exact=exact, max_splat=max_splat)[0][0].numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zbuffer_from_the_same_projection_equals_jax(seed):
    """``_zbuffer`` of both packages on the same projections, boxes and
    depths: the same index map, bit for bit, with collisions."""
    cam = _camera()
    pos = _patch(seed)
    x, y, d, v = jcam.project(jnp.asarray(pos), cam)
    bbox = jvis.splat_bboxes(cam, jnp.asarray(pos), x, y, d, voxel=0.05)
    ref, _ = jvis._zbuffer(x, y, d, v, bbox, SIZE, 8, True)
    ref = np.asarray(ref)
    t = [torch.from_numpy(np.array(a)) for a in (x, y, d, v)]
    tb = [torch.from_numpy(np.array(b)) for b in bbox]
    got = tvis._zbuffer(t[0], t[1], t[2], t[3], tb, SIZE, 8, True).numpy()
    assert got.dtype == np.int32 and got.shape == SIZE
    np.testing.assert_array_equal(got, ref)
    # the case collides: more points won a splat pixel than hold a centre
    splat = tvis._zbuffer(t[0], t[1], t[2], t[3], tb, SIZE, 8,
                          False).numpy()
    seen = np.unique(splat[splat >= 0])
    assert len(seen) > (got >= 0).sum() > 0
    # every mapped point was seen, at its own centre pixel, once
    xs, ys = np.nonzero(got >= 0)
    pts = got[xs, ys]
    assert len(np.unique(pts)) == len(pts)
    assert set(pts.tolist()) <= set(seen.tolist())
    np.testing.assert_array_equal(np.array(x)[pts].astype(np.int32), xs)
    np.testing.assert_array_equal(np.array(y)[pts].astype(np.int32), ys)


def test_collision_keeps_the_largest_index():
    """Two points at one depth whose centres share pixel (10, 20) and whose
    splat boxes differ by a column, so that both win a pixel: the larger
    index keeps the centre in both packages."""
    n = 2
    x = np.array([10.0, 10.9], np.float32)
    y = np.array([20.5, 20.5], np.float32)
    d = np.array([2.0, 2.0], np.float32)
    v = np.ones(n, bool)
    bbox = [np.array([8, 9], np.int32), np.array([12, 13], np.int32),
            np.array([19, 19], np.int32), np.array([22, 22], np.int32)]
    ref, _ = jvis._zbuffer(*(jnp.asarray(a) for a in (x, y, d, v)),
                           tuple(jnp.asarray(b) for b in bbox), SIZE, 8, True)
    got = tvis._zbuffer(*(torch.from_numpy(a) for a in (x, y, d, v)),
                        [torch.from_numpy(b) for b in bbox], SIZE, 8, True)
    ref, got = np.asarray(ref), got.numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[10, 20] == 1 and (got >= 0).sum() == 1


@pytest.mark.parametrize("voxel,max_splat", [(0.05, 8), (0.1, 5)])
def test_splat_zbuffer_batch_exact_equals_jax(voxel, max_splat):
    """End to end from the points (each package projects them itself) on a
    synthetic room and on a colliding patch: equal index maps."""
    scene = jsyn.make_scene(seed=3, density=40.0, n_cameras=1,
                            image_size=SIZE)
    room = jvox.grid_sample(scene.pos, voxel)["pos"].astype(np.float32)
    for cam, pos in ((scene.cameras[0], room), (_camera(), _patch(5))):
        ref = _jax_exact(cam, pos, voxel, max_splat)
        got = _torch_exact(cam, pos, voxel, max_splat)
        np.testing.assert_array_equal(got, ref)
        assert (got >= 0).sum() > 50


def test_zbuffer_exact_mode_center_only():
    """The port's counterpart of ``test_visibility.py::
    test_zbuffer_exact_mode_center_only`` on an equirectangular camera: one
    point, exactly one pixel mapped, at its centre projection (the splat
    alone covers several)."""
    cam = _torch_camera(_camera(size=(64, 64)))
    pts = torch.tensor([[2.0, 0.0, 0.0]])
    x, y, _, _ = tcam.project(pts, cam)
    splat = tvis.splat_zbuffer_batch([cam], pts, voxel=0.5, max_splat=8)[0][0]
    exact = tvis.splat_zbuffer_batch([cam], pts, voxel=0.5, max_splat=8,
                                     exact=True)[0][0]
    assert (splat >= 0).sum() > 1
    xs, ys = np.nonzero(exact.numpy() >= 0)
    assert len(xs) == 1
    assert (xs[0], ys[0]) == (int(x[0]), int(y[0])) == (31, 31)
