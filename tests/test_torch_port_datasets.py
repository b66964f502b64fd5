"""The dataset path of the PyTorch port against the JAX package: mapping
reindexing, the 3D / 2D sample transforms, the ``.npz`` area caches, the
sphere sampler, the bucket loader and ``build_synthetic_cache``.

Everything but the cache build is host numpy copied from the JAX package,
so it must give byte-identical arrays from the same inputs and the same
``np.random.Generator`` seed.  The cache build runs kNN, PCA and the
z-buffers in torch: held to the bounds of ``test_build_mappings_matches_jax``
(99.5% of the pixel triplets and views shared, view features within 1e-4),
positions, colours and labels byte-identical.
"""

import dataclasses
import functools

import numpy as np
import pytest

from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data import mapping as jmapping
from deepviewagg_tpu.data import transforms2d as jt2
from deepviewagg_tpu.data import transforms3d as jt3
from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import synthetic_ds as jsds
from deepviewagg_tpu_torch.data import collate as tcollate
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.data import transforms2d as tt2
from deepviewagg_tpu_torch.data import transforms3d as tt3
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import synthetic_ds as tsds
from torch_port_util import _torch_threads, jax_tiny_batch  # noqa: F401

CACHE = dict(n_areas=2, density=30.0, n_cameras=3, image_size=(64, 32))
AUG = dict(noise_sigma=0.01, rotate_axis=2, scales=[0.9, 1.1],
           symmetry_axes=[True, False, False])


def assert_identical(a, b, path=""):
    """Same structure; arrays of the same dtype, shape and bytes; mappings
    and samples field by field (the two packages' classes differ)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_identical(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_identical(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _to_torch_mapping(m):
    return tmapping.MultiViewMapping(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """Area paths of a synthetic cache written by the JAX package."""
    root = tmp_path_factory.mktemp("jax_cache")
    return jsds.build_synthetic_cache(str(root), **CACHE)


# --- mapping reindexing ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mapping():
    return jax_tiny_batch()[1][0].mapping


def _cases():
    m = _mapping()
    rng = np.random.default_rng(3)
    n, q, v = m.num_points, m.pixel_capacity, m.view_capacity
    sub = np.sort(rng.choice(n, n // 3, replace=False))
    return {
        "select_points": lambda mm: mm.select_points(sub),
        "select_points_empty": lambda mm: mm.select_points(
            np.zeros(0, np.int64)),
        "select_points_all": lambda mm: mm.select_points(np.arange(n)),
        "select_then_compact": lambda mm: mm.select_points(sub).compact(),
        "compact_with_margins": lambda mm: mm.select_points(sub).compact(7, 9),
        "select_images": lambda mm: mm.select_images([0]).compact(),
        "select_images_empty": lambda mm: mm.select_images(
            np.zeros(0, np.int64)),
        "select_images_all": lambda mm: mm.select_images(
            np.arange(mm.num_images)),
        "drop_pixels": lambda mm: mm.drop_pixels(rng_mask(q, 11)),
        "drop_pixels_none_kept": lambda mm: mm.drop_pixels(np.zeros(q, bool)),
        "drop_views": lambda mm: mm.drop_views(rng_mask(v, 12)),
        "drop_views_none_kept": lambda mm: mm.drop_views(np.zeros(v, bool)),
        "points_seen": lambda mm: mm.select_points(sub).points_seen(),
    }


def rng_mask(size, seed):
    return np.random.default_rng(seed).random(size) < 0.6


@pytest.mark.parametrize("case", sorted(_cases()))
def test_mapping_methods_identical(case):
    m = _mapping()
    op = _cases()[case]
    ref, got = op(m), op(_to_torch_mapping(m))
    assert_identical(ref, got)
    if isinstance(ref, jmapping.MultiViewMapping):
        got.check()


# --- transforms ----------------------------------------------------------------

def _cloud(path, pkg):
    return pkg.load_area(path)


def test_transforms3d_identical(jax_cache):
    jcloud, tcloud = _cloud(jax_cache[0], jbase), _cloud(jax_cache[0], tbase)
    tcloud["mapping"] = _to_torch_mapping(tcloud["mapping"])
    center = jcloud["pos"][17]
    for select in ("sphere_select", "cylinder_select"):
        ref = getattr(jt3, select)(jcloud, center, 1.5)
        got = getattr(tt3, select)(tcloud, center, 1.5)
        assert_identical(ref, got)
    chain = [("RandomNoise", dict(sigma=0.02)),
             ("RandomRotate", dict(axis="z")),
             ("RandomRotate", dict(axis="x", degrees=20.0)),
             ("RandomScaleAnisotropic", dict(scale_min=0.8, scale_max=1.2)),
             ("RandomSymmetry", dict(axes=(True, True, False)))]
    ja = jt3.Compose([getattr(jt3, n)(**kw) for n, kw in chain])
    ta = tt3.Compose([getattr(tt3, n)(**kw) for n, kw in chain])
    ref = ja(jt3.sphere_select(jcloud, center, 1.5), np.random.default_rng(5))
    got = ta(tt3.sphere_select(tcloud, center, 1.5), np.random.default_rng(5))
    assert_identical(ref, got)
    assert_identical(jt3.quantize_cloud(ref, 0.1), tt3.quantize_cloud(got, 0.1))


def test_transforms2d_identical(jax_cache):
    jcloud, tcloud = _cloud(jax_cache[1], jbase), _cloud(jax_cache[1], tbase)
    tcloud["mapping"] = _to_torch_mapping(tcloud["mapping"])
    center = jcloud["pos"][3]
    jsub = jt3.quantize_cloud(jt3.sphere_select(jcloud, center, 2.0), 0.1)
    tsub = tt3.quantize_cloud(tt3.sphere_select(tcloud, center, 2.0), 0.1)
    for kw in (dict(min_points=8), dict(min_points=10 ** 6),
               dict(use_bbox=True, area_ratio=0.05)):
        assert_identical(jt2.pick_images_by_area(jsub, **kw),
                         tt2.pick_images_by_area(tsub, **kw))
    for slots in (1, 2, 5):
        assert_identical(
            jt2.pick_images_by_credit(jsub, slots, np.random.default_rng(2)),
            tt2.pick_images_by_credit(tsub, slots, np.random.default_rng(2)))
    jm, tm = jsub["mapping"], tsub["mapping"]
    for n in (0, 1, 2, 7):
        assert_identical(jt2.select_images_by_coverage(jm, n),
                         tt2.select_images_by_coverage(tm, n))
    px = np.array([2048, 1024, 4096], np.int64)[:jm.num_images]
    for budget in (100, 2048, 5000, 10 ** 6):
        assert_identical(jt2.select_images_by_credit(jm, budget, px),
                         tt2.select_images_by_credit(tm, budget, px))
    images = jcloud["images"][:2]
    for im in (images, (images * 255).astype(np.uint8), images * 255):
        assert_identical(jt2.normalize_images(im), tt2.normalize_images(im))


# --- caches --------------------------------------------------------------------

def test_cache_written_by_jax_loads_identically(jax_cache):
    for path in jax_cache:
        assert jbase.stale_area_cache(path) is tbase.stale_area_cache(path)
        ref, got = jbase.load_area(path), tbase.load_area(path)
        assert isinstance(got["mapping"], tmapping.MultiViewMapping)
        assert_identical(ref, got)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_cache_written_by_port_loads_identically_in_jax(jax_cache, tmp_path,
                                                        uint8):
    """Float image stacks stay in the ``.npz``; uint8 ones go to the
    ``_images.npy`` sidecar, memory-mapped on load by either package."""
    cloud = tbase.load_area(jax_cache[0])
    if uint8:
        cloud["images"] = (cloud["images"] * 255).astype(np.uint8)
    path = str(tmp_path / "area.npz")
    tbase.save_area(path, cloud)
    jpath = str(tmp_path / "jax_area.npz")
    jbase.save_area(jpath, dict(cloud, mapping=jmapping.MultiViewMapping(**{
        f.name: getattr(cloud["mapping"], f.name)
        for f in dataclasses.fields(cloud["mapping"])})))
    assert not jbase.stale_area_cache(path)
    ref = jbase.load_area(path)
    assert isinstance(ref["images"], np.memmap) is uint8
    assert_identical(jbase.load_area(jpath), ref)
    assert_identical(tbase.load_area(path), ref)


def test_area_cache_evicts_least_recently_used(jax_cache):
    loads = []
    cache = tbase.AreaCache(jax_cache, max_loaded=1,
                            loader=lambda p: loads.append(p) or {"p": p})
    assert [cache.get(i)["p"] for i in (0, 0, 1, 0)] == [
        jax_cache[0], jax_cache[0], jax_cache[1], jax_cache[0]]
    assert loads == [jax_cache[0], jax_cache[1], jax_cache[0]]


def test_port_built_cache_matches_jax_cache(jax_cache, tmp_path):
    """The cache build on the CPU: the same voxel grid and labels; the
    mapping and the images as far as float32 kNN / PCA / z-buffer noise
    lets them agree."""
    paths = tsds.build_synthetic_cache(str(tmp_path), device="cpu", **CACHE)
    for jp, tp in zip(jax_cache, paths):
        ref, got = jbase.load_area(jp), tbase.load_area(tp)
        for key in ("pos", "rgb", "labels", "origin_id"):
            assert_identical(ref[key], got[key], key)
        assert np.abs(ref["normal"] - got["normal"]).max() <= 1e-4

        def triplets(m):
            pv = m.pix_view[m.pix_valid]
            return set(zip(m.point_id[pv].tolist(), m.image_id[pv].tolist(),
                           m.pix_x[m.pix_valid].tolist(),
                           m.pix_y[m.pix_valid].tolist()))

        a, b = triplets(ref["mapping"]), triplets(got["mapping"])
        assert len(a) > 1000
        assert len(a & b) >= 0.995 * max(len(a), len(b))

        def views(m):
            v = m.view_valid
            return {(p, i): f for p, i, f in zip(
                m.point_id[v].tolist(), m.image_id[v].tolist(),
                m.view_feats[v])}

        va, vb = views(ref["mapping"]), views(got["mapping"])
        both = sorted(set(va) & set(vb))
        assert len(both) >= 0.995 * max(len(va), len(vb))
        assert np.abs(np.stack([va[k] for k in both])
                      - np.stack([vb[k] for k in both])).max() <= 1e-4
        assert ref["images"].shape == got["images"].shape
        assert (np.asarray(ref["images"]) == np.asarray(got["images"])).mean() \
            >= 0.99


# --- sphere dataset and loader ----------------------------------------------

def _datasets(paths, train, pkg, **kw):
    aug = pkg.build_augment(AUG, None) if train else None
    return pkg.SphereDataset(
        areas=pkg.AreaCache(paths, max_loaded=2), radius=1.5, voxel_size=0.1,
        num_classes=4, train=train, augment=aug, image_slots=2,
        samples_per_epoch=6, seed=7, **kw)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sphere_dataset_samples_identical(jax_cache, train):
    jds = _datasets(jax_cache, train, jbase)
    tds = _datasets(jax_cache, train, tbase)
    assert len(jds) == len(tds) > 1
    for i in range(len(jds)):
        ref, got = jds[i], tds[i]
        if ref is None:
            assert got is None
            continue
        assert isinstance(got, tcollate.Sample)
        assert_identical(ref, got)
    if not train:
        # the eval budget keeps at most image_slots images per sphere
        assert all(s is None or len(s.images) <= 2
                   for s in (tds[i] for i in range(len(tds))))


def test_batch_loader_identical_with_a_split(jax_cache):
    """One epoch of both loaders over the same dataset and seed, with a
    voxel cap that forces ``_split_sample`` on the largest spheres."""
    jds = _datasets(jax_cache, True, jbase)
    tds = _datasets(jax_cache, True, tbase)
    sizes = [len(s.coords) for s in (_datasets(jax_cache, True, jbase)[i]
                                      for i in range(6)) if s is not None]
    caps = dict(level_caps=[int(max(sizes) * 0.8), 2048, 1024, 512, 256],
                num_batches=2, view_cap=4096, pix_cap=16384, image_cap=4)
    jl = jbase.BatchLoader(jds, jcollate.Bucket(**caps), 2, [0], seed=3)
    tl = tbase.BatchLoader(tds, tcollate.Bucket(**caps), 2, [0], seed=3)
    ref, got = list(jl), list(tl)
    assert tl.stats == jl.stats and tl.stats["split"] >= 1
    assert len(ref) == len(got) >= 3
    for a, b in zip(ref, got):
        ma, mb = a.pop("meta"), b.pop("meta")
        assert_identical(a, b)
        assert ma["sizes"] == mb["sizes"] and ma["clouds"] == mb["clouds"]
        assert_identical(ma["origin_ids"], mb["origin_ids"])


def test_batch_loader_raises_worker_errors_and_stops_early(jax_cache):
    tds = _datasets(jax_cache, True, tbase)
    caps = dict(level_caps=[4096, 2048, 1024, 512, 256], num_batches=2,
                view_cap=4096, pix_cap=16384, image_cap=4)
    loader = tbase.BatchLoader(tds, tcollate.Bucket(**caps), 2, [0], seed=3)
    it = iter(loader)
    next(it)
    it.close()                      # joins the prefetch thread

    class Failing:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"sample {i} failed")

    bad = tbase.BatchLoader(Failing(), tcollate.Bucket(**caps), 2, [0])
    with pytest.raises(RuntimeError, match="failed"):
        list(bad)


def test_augment_params_match_jax():
    for train in (True, False):
        ap = dict(AUG, k_coverage=3.0, use_bbox=True)
        assert tbase.dataset_aug_kwargs(ap, train) == \
            jbase.dataset_aug_kwargs(ap, train)
    assert tbase.build_augment({}, None) is None
    chain = tbase.build_augment(AUG, None)
    assert [type(t).__name__ for t in chain.transforms] == [
        type(t).__name__ for t in jbase.build_augment(AUG, None).transforms]


@pytest.mark.parametrize("option", [
    dict(center_roll=True), dict(flip_p=0.5), dict(jitter_mapping=0.01),
    dict(color_jitter=(0.6, 0.6, 0.7)), dict(blur_p=0.1)],
    ids=lambda o: next(iter(o)))
def test_sphere_dataset_refuses_unported_options(jax_cache, option):
    with pytest.raises(NotImplementedError, match="ROADMAP A.2.2"):
        _datasets(jax_cache, True, tbase, **option)
