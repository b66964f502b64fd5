"""Host code and device preprocessing of the PyTorch port against the JAX
package.

The numpy host copies (``pad_to``, voxel grid sampling, kernel maps, the
UNet graph, the mapping tables and ``collate``, the synthetic scenes) must
give byte-identical arrays on the same input.  The device preprocessing
(projection, splat boxes, kNN, PCA features, the splatting z-buffer behind
``build_mappings``) runs in plain torch and agrees within float32 noise.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.core import cameras as jcam
from deepviewagg_tpu.core import csr as jcsr
from deepviewagg_tpu.core import visibility as jvis
from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data import geometric as jgeo
from deepviewagg_tpu.data import mapping_factory as jmf
from deepviewagg_tpu.data import synthetic as jsyn
from deepviewagg_tpu.data import toy as jtoy
from deepviewagg_tpu.ops import kernel_map as jkm
from deepviewagg_tpu.ops import knn as jknn
from deepviewagg_tpu.ops import sparse_graph as jsg
from deepviewagg_tpu.ops import voxel as jvox
from deepviewagg_tpu_torch.core import cameras as tcam
from deepviewagg_tpu_torch.core import csr as tcsr
from deepviewagg_tpu_torch.core import visibility as tvis
from deepviewagg_tpu_torch.data import collate as tcollate
from deepviewagg_tpu_torch.data import geometric as tgeo
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data import mapping_factory as tmf
from deepviewagg_tpu_torch.data import synthetic as tsyn
from deepviewagg_tpu_torch.ops import kernel_map as tkm
from deepviewagg_tpu_torch.ops import knn as tknn
from deepviewagg_tpu_torch.ops import sparse_graph as tsg
from deepviewagg_tpu_torch.ops import voxel as tvox
from torch_port_util import (_torch_threads, jax_ladder_batch,  # noqa: F401
                             ladder_bucket, rel_err, to_torch_samples)


def assert_trees_identical(a, b, path=""):
    """Same keys, and every array of the same dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_trees_identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_identical(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _coords(seed=0, n=600, batches=2, span=12):
    """Unique voxel coords ``[b, x, y, z]`` (voxel grids hold no repeats)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-span, span, size=(n, 3))
    b = rng.integers(0, batches, size=(n, 1))
    return np.unique(np.concatenate([b, c], axis=1).astype(np.int32), axis=0)


# --- host copies: byte-identical -----------------------------------------

def test_pad_to_identical():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for size, axis, fill in [(9, 0, 0), (7, 1, -1), (6, 0, 3)]:
        assert_trees_identical(jcsr.pad_to(x, size, axis, fill),
                               tcsr.pad_to(x, size, axis, fill))


def test_voxel_grid_sample_and_downsample_identical():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-2, 2, size=(800, 3)).astype(np.float32)
    feats = rng.normal(size=(800, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 800).astype(np.int32)
    assert_trees_identical(
        jvox.grid_sample(pos, 0.1, feats=feats, labels=labels),
        tvox.grid_sample(pos, 0.1, feats=feats, labels=labels))
    c = _coords()
    for stride in (2, 4):
        assert_trees_identical(jvox.downsample_coords(c, stride),
                               tvox.downsample_coords(c, stride))


@pytest.mark.parametrize("ks,stride", [(3, 1), (2, 2), (5, 1)])
def test_kernel_map_identical(ks, stride):
    assert_trees_identical(jkm.kernel_offsets(ks), tkm.kernel_offsets(ks))
    c_in = _coords(2)
    c_out = tvox.downsample_coords(c_in, stride)[0] if stride > 1 else c_in
    a = jkm.build_kernel_map(c_in, c_out, ks, stride)
    b = tkm.build_kernel_map(c_in, c_out, ks, stride)
    assert_trees_identical(dataclasses.asdict(a), dataclasses.asdict(b))


def test_unet_graph_identical():
    c = _coords(3, n=900)
    a = jsg.graph_to_device(jsg.build_unet_graph(
        c, 5, num_batches=2, conv0_kernel=3, cap_multiple=128))
    b = tsg.graph_to_device(tsg.build_unet_graph(
        c, 5, num_batches=2, conv0_kernel=3, cap_multiple=128))
    assert_trees_identical(a, b)


def _to_torch_mapping(m):
    return tmapping.MultiViewMapping(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


@functools.lru_cache(maxsize=None)
def _jax_toy():
    """Two samples of two cameras, branches at levels 0 and 1, so the
    stride merge of the mappings runs."""
    return jtoy.toy_batch(n_samples=2, density=25.0, image_size=(64, 32),
                          n_cameras=2, branch_levels=(0, 1))


def test_collate_identical_on_the_same_samples():
    batch, bucket, samples = _jax_toy()
    tsamples = [
        tcollate.Sample(**{f.name: getattr(s, f.name)
                           for f in dataclasses.fields(s)
                           if f.name != "mapping"},
                        mapping=_to_torch_mapping(s.mapping))
        for s in samples]
    tbucket = tcollate.Bucket(**dataclasses.asdict(bucket))
    got = tcollate.collate(tsamples, tbucket, branch_levels=(0, 1),
                           conv0_kernel=3)
    ref = {k: v for k, v in batch.items() if k != "meta"}
    got = {k: v for k, v in got.items() if k != "meta"}
    assert_trees_identical(ref, got)
    assert set(ref["mappings"]) == {0, 1}
    # the mapping tables of one sample, padded and shipped
    m = samples[1].mapping
    assert_trees_identical(m.pad(m.view_capacity + 5, m.pixel_capacity + 7)
                           .to_device(),
                           _to_torch_mapping(m).pad(
                               m.view_capacity + 5, m.pixel_capacity + 7)
                           .to_device())


def _drop_meta(batch):
    return {k: v for k, v in batch.items() if k != "meta"}


def test_ladder_collate_identical_on_the_same_samples():
    """The ``Bucket.image_ladder`` branch, bbox-fitted crops: views spread
    over three buckets, one bucket without an image slot, mappings at levels
    0 and 1 over one shared list of bucket images."""
    ref, bucket, samples = jax_ladder_batch()
    tbucket = tcollate.Bucket(**dataclasses.asdict(bucket))
    got = tcollate.collate(to_torch_samples(samples), tbucket,
                           branch_levels=[0, 1])
    assert_trees_identical(ref, _drop_meta(got))
    assert "images" not in got and len(got["bucket_images"]) == 4
    assert got["bucket_images"][0].shape == (0, 8, 4, 3)
    for lvl in (0, 1):
        mm = got["mappings"][lvl]
        assert sorted(mm) == ["buckets", "view"]
        assert [int(b["pix_valid"].sum()) > 0 for b in mm["buckets"]] \
            == [False, True, True, True]
        vc = len(mm["view"]["view_valid"])
        for b in mm["buckets"]:
            assert "images" not in b and "size" not in b
            assert b["pix_ptr"].dtype == np.int32 and len(b["pix_ptr"]) == vc + 2
            assert b["pix_ptr"][-1] == len(b["pix_view"])
    # what the model and the segment kernel's wrapper take: int32 ptr and
    # ids, bool masks, float32 images, nesting kept
    moved = tcollate.batch_to_torch(got, device="cpu")
    b3 = moved["mappings"][1]["buckets"][3]
    assert b3["pix_ptr"].dtype == torch.int32 and b3["pix_valid"].dtype == torch.bool
    assert moved["mappings"][0]["view"]["point_ptr"].dtype == torch.int32
    assert isinstance(moved["bucket_images"], list)
    assert moved["bucket_images"][3].dtype == torch.float32
    assert moved["meta"] is got["meta"]


def test_ladder_collate_routes_camera_families_identically():
    """``Sample.image_family`` set: every image goes to its family's bucket
    at origin 0, whatever its pixels' bounding box."""
    _, _, samples = jax_ladder_batch()
    fams = [np.array([3, 0]), np.array([2, 3])]
    jsamples = [dataclasses.replace(s, image_family=f)
                for s, f in zip(samples, fams)]
    tsamples = [dataclasses.replace(s, image_family=f)
                for s, f in zip(to_torch_samples(samples), fams)]
    jbucket = ladder_bucket(jsamples, jcollate.Bucket, jvox, families=True)
    tbucket = tcollate.Bucket(**dataclasses.asdict(jbucket))
    ref = jcollate.collate(jsamples, jbucket, branch_levels=[0])
    got = tcollate.collate(tsamples, tbucket, branch_levels=[0])
    assert_trees_identical(_drop_meta(ref), _drop_meta(got))
    buckets = got["mappings"][0]["buckets"]
    assert [int(b["pix_image"].max()) for b in buckets] == [0, 0, 0, 1]
    assert [int(b["pix_valid"].sum()) > 0 for b in buckets] \
        == [True, False, True, True]
    # the crop is the canvas corner: the first image of the (8, 4) family
    np.testing.assert_array_equal(got["bucket_images"][0][0],
                                  samples[0].images[1][:8, :4])


@pytest.mark.parametrize("which", ["images", "pixels"])
def test_ladder_collate_overflow_raises_as_in_jax(which):
    _, bucket, samples = jax_ladder_batch()
    caps = dict(ladder_image_caps=[0, 1, 2, 1]) if which == "images" else dict(
        ladder_pix_caps=[64, 64, 5120, 5120])
    match = ("crop bucket 3 overflows image cap" if which == "images"
             else "crop bucket 1 overflows caps")
    jbucket = dataclasses.replace(bucket, **caps)
    with pytest.raises(ValueError, match=match) as jerr:
        jcollate.collate(list(samples), jbucket, branch_levels=[0])
    with pytest.raises(ValueError, match=match) as terr:
        tcollate.collate(to_torch_samples(samples),
                         tcollate.Bucket(**dataclasses.asdict(jbucket)),
                         branch_levels=[0])
    assert str(terr.value) == str(jerr.value)


def test_synthetic_scene_and_render_identical():
    a = jsyn.make_scene(seed=4, density=20.0, n_cameras=2, image_size=(32, 16))
    b = tsyn.make_scene(seed=4, density=20.0, n_cameras=2, image_size=(32, 16))
    for f in ("pos", "rgb", "labels"):
        assert_trees_identical(getattr(a, f), getattr(b, f))
    for ca, cb in zip(a.cameras, b.cameras):
        for f in dataclasses.fields(ca):
            va, vb = getattr(ca, f.name), getattr(cb, f.name)
            if isinstance(va, np.ndarray):
                assert_trees_identical(va, vb)
            else:
                assert va == vb, f.name
    m = _jax_toy()[2][0].mapping
    scene = jsyn.make_scene(seed=0, density=25.0, n_cameras=2,
                            image_size=(64, 32))
    tscene = tsyn.make_scene(seed=0, density=25.0, n_cameras=2,
                             image_size=(64, 32))
    assert_trees_identical(jsyn.render_views(scene, m),
                           tsyn.render_views(tscene, _to_torch_mapping(m)))


# --- device preprocessing: float32 noise ---------------------------------

@functools.lru_cache(maxsize=None)
def _scene():
    scene = jsyn.make_scene(seed=5, density=30.0, n_cameras=2,
                            image_size=(96, 48))
    g = jvox.grid_sample(scene.pos, 0.1)
    return scene, g["pos"].astype(np.float32)


def _torch_camera(cam):
    return tcam.Camera(**{f.name: getattr(cam, f.name)
                          for f in dataclasses.fields(cam)})


def test_project_and_splat_bboxes_match_jax():
    scene, pos = _scene()
    for cam in scene.cameras:
        jx, jy, jd, jv = (np.array(a) for a in jcam.project(jnp.asarray(pos), cam))
        tx, ty, td, tv = (a.numpy() for a in tcam.project(
            torch.from_numpy(pos), _torch_camera(cam)))
        for t, j in ((tx, jx), (ty, jy), (td, jd)):
            assert rel_err(t, j) <= 1e-5
        assert (tv == jv).mean() >= 0.999
        # the boxes from the same projections: identical except where a
        # float32 difference moves a value across a .5 rounding boundary
        jb = jvis.splat_bboxes(cam, jnp.asarray(pos), jnp.asarray(jx),
                               jnp.asarray(jy), jnp.asarray(jd), voxel=0.1)
        tb = tvis.splat_bboxes(_torch_camera(cam), torch.from_numpy(pos),
                               torch.from_numpy(jx), torch.from_numpy(jy),
                               torch.from_numpy(jd), voxel=0.1)
        for a, b in zip(jb, tb):
            a, b = np.asarray(a), b.numpy()
            assert b.dtype == np.int32
            assert np.abs(a.astype(np.int64) - b).max() <= 1
            assert (a == b).mean() >= 0.999


def test_knn_distances_match_jax():
    _, pos = _scene()
    jd, _ = jknn.knn(pos, pos, k=16, block=256)
    td, ti = tknn.knn(torch.from_numpy(pos), torch.from_numpy(pos), k=16,
                      block=256)
    # indices may differ between neighbors at exactly equal distance.  Both
    # sides expand |q - p|^2 = |q|^2 + |p|^2 - 2 q.p in float32, whose
    # cancellation error scales with |p|^2, not with the distance
    scale = float((pos.astype(np.float64) ** 2).sum(axis=1).max())
    assert np.abs(td.numpy() - jd).max() <= 1e-6 * scale
    np.testing.assert_array_equal(ti[:, 0].numpy(), np.arange(len(pos)))


def test_pca_features_match_jax():
    _, pos = _scene()
    ref = jgeo.pca_features(pos, k=20)
    got = tgeo.pca_features(pos, k=20, device="cpu")
    for key in ("linearity", "planarity", "scattering"):
        assert np.abs(got[key].numpy() - ref[key]).max() <= 1e-4, key
    # normals: same eigenvector up to float32 noise, both oriented +z
    assert np.abs(got["normal"].numpy() - ref["normal"]).max() <= 1e-4


def test_build_mappings_matches_jax():
    scene, pos = _scene()
    params = dict(voxel=0.1, max_splat=5)
    ref = jmf.build_mappings(pos, scene.cameras, jmf.VisibilityParams(**params))
    got = tmf.build_mappings(pos, [_torch_camera(c) for c in scene.cameras],
                             tmf.VisibilityParams(**params), device="cpu")

    def triplets(m):
        pv = m.pix_view[m.pix_valid]
        return set(zip(m.point_id[pv].tolist(), m.image_id[pv].tolist(),
                       m.pix_x[m.pix_valid].tolist(),
                       m.pix_y[m.pix_valid].tolist()))

    a, b = triplets(ref), triplets(got)
    assert len(a) > 1000
    assert len(a & b) >= 0.995 * max(len(a), len(b))

    def views(m):
        v = m.view_valid
        return {(p, i): f for p, i, f in zip(m.point_id[v].tolist(),
                                             m.image_id[v].tolist(),
                                             m.view_feats[v])}

    va, vb = views(ref), views(got)
    both = sorted(set(va) & set(vb))
    assert len(both) >= 0.995 * max(len(va), len(vb))
    fa = np.stack([va[k] for k in both])
    fb = np.stack([vb[k] for k in both])
    assert np.abs(fa - fb).max() <= 1e-4
