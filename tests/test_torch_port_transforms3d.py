"""The 32 names of ``data/transforms3d.py`` that the port gained in its last
slice (the crop / dropout family, the chromatic and feature transforms,
``ElasticDistortion``, ``RandomDropout``, ``LotteryTransform``,
``RandomParamTransform``, ``planarity_filter`` ...), against the JAX
package's: each applied to the same cloud with a ``np.random.Generator`` of
the same seed gives a byte-identical cloud (every array, and the mapping's
tables), and leaves the generator in the same state.

The cloud is a toy sample's voxels (5 cm) within 1 m of its centre, with their
mapping, centred and rounded to multiples of 2^-10: there every product and
sum of the kNN's expanded squared distances is exact in float32, in both
packages, and the points are thinned until no two of a point's 12 nearest
lie at equal distances.  So ``RandomWalkDropout`` and ``DensityFilter``
(the port's on the CPU here, on the card in ``chip_smoke.py`` 13d) see the
same neighbours in the same order.
"""

import dataclasses
import functools

import numpy as np
import pytest

from deepviewagg_tpu.data import toy as jtoy
from deepviewagg_tpu.data import transforms3d as jt
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data import transforms3d as tt
from torch_port_util import _torch_threads  # noqa: F401

LATTICE = 2.0 ** -10
TIES_K = 12


def _ties_free(pos):
    """Rows of ``pos`` (multiples of LATTICE) kept so that no point's
    TIES_K + 1 nearest hold two equal distances (exact integer arithmetic)."""
    keep = np.arange(len(pos))
    while True:
        p = np.round(pos[keep] / LATTICE).astype(np.int64)
        d = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        near = np.sort(d, axis=1)[:, :TIES_K + 2]
        tied = (np.diff(near, axis=1) == 0).any(axis=1)
        if not tied.any():
            return keep
        keep = keep[~tied]


@functools.lru_cache(maxsize=None)
def _clouds():
    """(JAX cloud, port cloud): the same arrays, each package's mapping."""
    s = jtoy.toy_samples(n_samples=1, density=120.0, image_size=(64, 32),
                         n_cameras=2, voxel_size=0.05)[0]
    n = len(s.pos)
    rng = np.random.default_rng(0)
    cloud = {"pos": s.pos.astype(np.float32), "rgb": s.feats[:, :3].copy(),
             "labels": s.labels, "mapping": s.mapping,
             "normal": rng.normal(size=(n, 3)).astype(np.float32),
             "coords": s.coords.copy(),
             "origin_id": np.arange(n, dtype=np.int64)}
    centre = np.median(cloud["pos"], axis=0)
    cloud = jt.sphere_select(cloud, centre, 1.0)
    cloud["pos"] = (np.round((cloud["pos"] - centre) / LATTICE)
                    * LATTICE).astype(np.float32)
    cloud = jt.select_rows(cloud, _ties_free(cloud["pos"]))
    assert len(cloud["pos"]) > 300
    port = dict(cloud, mapping=tmapping.MultiViewMapping(**{
        f.name: getattr(cloud["mapping"], f.name)
        for f in dataclasses.fields(cloud["mapping"])}))
    return cloud, port


CPU = {"device": "cpu"}
# name -> (make(module, port_kwargs) -> transform, seeds)
TRANSFORMS = {
    "ElasticDistortion": lambda m, kw: m.ElasticDistortion(),
    "RandomDropout": lambda m, kw: m.RandomDropout(0.3, p=0.9),
    "SphereCrop": lambda m, kw: m.SphereCrop(radius=0.6),
    "CubeCrop": lambda m, kw: m.CubeCrop(c=0.5),
    "EllipsoidCrop": lambda m, kw: m.EllipsoidCrop(0.8, 0.5, 0.4),
    "RandomSphereDropout": lambda m, kw: m.RandomSphereDropout(3, 0.3),
    "FixedSphereDropout": lambda m, kw: m.FixedSphereDropout(
        [[0.2, 0.1, 0.0], [-0.5, 0.3, 0.2]], 0.35),
    "RandomWalkDropout": lambda m, kw: m.RandomWalkDropout(
        dropout_ratio=0.2, num_iter=400, **kw),
    "DensityFilter": lambda m, kw: m.DensityFilter(radius_nn=0.12, min_num=4,
                                                   k=TIES_K, **kw),
    "PeriodicSampling": lambda m, kw: m.PeriodicSampling(0.3, 0.5),
    "ShuffleData": lambda m, kw: m.ShuffleData(),
    "ShiftVoxels": lambda m, kw: m.ShiftVoxels(),
    "RandomTranslation": lambda m, kw: m.RandomTranslation(0.2),
    "ChromaticTranslation": lambda m, kw: m.ChromaticTranslation(p=0.9),
    "ChromaticAutoContrast": lambda m, kw: m.ChromaticAutoContrast(p=0.9),
    "ChromaticJitter": lambda m, kw: m.ChromaticJitter(0.05, p=0.9),
    "DropFeature": lambda m, kw: m.DropFeature(0.8),
    "XYZFeature": lambda m, kw: m.XYZFeature(add_y=False),
    "AddOnes": lambda m, kw: m.AddOnes(),
    "AddFeatsByKeys": lambda m, kw: m.Compose(
        [m.AddOnes(), m.AddFeatsByKeys(["rgb", "ones", "labels"])]),
    "Random3AxisRotation": lambda m, kw: m.Random3AxisRotation(
        rot_x=10, rot_y=5, rot_z=180),
    "RandomCoordsFlip": lambda m, kw: m.RandomCoordsFlip(p=0.6),
    "NormalizeRGB": lambda m, kw: m.Compose(
        [m.ScalePos(1.0), lambda c, r: dict(c, rgb=c["rgb"] * 255),
         m.NormalizeRGB()]),
    "NormalizeFeature": lambda m, kw: m.Compose(
        [m.NormalizeFeature("rgb"), m.NormalizeFeature("normal",
                                                       standardize=True)]),
    "ScalePos": lambda m, kw: m.ScalePos(2.5),
    "RemoveAttributes": lambda m, kw: m.RemoveAttributes(["normal", "nope"]),
    "AddFeatByKey": lambda m, kw: m.Compose(
        [m.AddFeatByKey("rgb"), m.AddFeatByKey("labels")]),
    "LotteryTransform": lambda m, kw: m.LotteryTransform(
        [m.RandomTranslation(0.1), m.ScalePos(2.0),
         m.RandomWalkDropout(dropout_ratio=0.1, num_iter=100, **kw)]),
    "RandomParamTransform": lambda m, kw: m.RandomParamTransform(
        m.SphereCrop, {"radius": {"min": 0.3, "max": 0.9}}),
    "IrregularSampling": lambda m, kw: m.IrregularSampling(d_half=0.5),
    "CylinderNormalizeScale": lambda m, kw: m.CylinderNormalizeScale(),
}


def _assert_same_cloud(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key == "mapping":
            for f in dataclasses.fields(w):
                a, b = getattr(g, f.name), getattr(w, f.name)
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), f
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
        else:
            assert g == w, key


EARLIER = {"Compose", "RandomRotate", "RandomScaleAnisotropic", "RandomNoise",
           "RandomSymmetry", "sphere_select", "cylinder_select",
           "quantize_cloud"}


def test_every_jax_name_is_here():
    """The port lists the JAX module's names (and its own ``select_rows``);
    the 32 this file holds are all of them but the sphere path's eight,
    which ``test_torch_port_datasets.py`` holds."""
    assert sorted(tt.__all__) == sorted(jt.__all__ + ["select_rows"])
    assert set(TRANSFORMS) | {"planarity_filter"} == set(jt.__all__) - EARLIER
    assert len(set(jt.__all__) - EARLIER) == 32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, seed):
    jcloud, tcloud = _clouds()
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = TRANSFORMS[name](jt, {})(dict(jcloud), jrng)
    got = TRANSFORMS[name](tt, CPU)(dict(tcloud), trng)
    _assert_same_cloud(got, want)
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("thresh,is_leq", [(0.3, True), (0.3, False),
                                           (0.9, True)])
def test_planarity_filter_matches_jax(thresh, is_leq):
    jcloud, tcloud = _clouds()
    flat = dict(jcloud, pos=jcloud["pos"] * np.float32([1, 1, 0.01]))
    for cloud in (jcloud, flat):
        assert tt.planarity_filter(cloud, thresh, is_leq) is \
            jt.planarity_filter(cloud, thresh, is_leq)


def test_knn_transforms_take_their_device():
    import inspect

    for cls in (tt.RandomWalkDropout, tt.DensityFilter):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
