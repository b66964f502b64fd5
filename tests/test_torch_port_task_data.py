"""The port's task datasets (``data/datasets/tasks.py``) against the JAX
package's: procedural items and the on-disk layouts they read (a ModelNet
OFF tree, ``scene_*.npz`` box / panoptic scenes, ``pair_*.npz`` fragment
pairs), and the task collates.

Everything that involves no neighbour search is the same array, dtype,
shape and bytes: OFF sampling, the procedural shapes, scenes and fragment
pairs, voxel grids, the collated sparse graphs, labels, instance ids and
pair tables.  The detection items carry a pointnet graph and proposal
clusters, whose FPS centres are equal index for index and whose ball
queries are held as the share of identical rows (at least 99%; all of them
on these inputs), as in ``test_torch_port_spatial.py``, their upsampling
distances to 4 float32 ulps of the largest squared coordinate (the expanded
form ``|q|^2 + |p|^2 - 2 q.p`` rounds there: 1.1e-5 seen in a room of 6 m).
"""

import numpy as np
import pytest

from deepviewagg_tpu.data.collate import Bucket as JBucket
from deepviewagg_tpu.data.datasets import tasks as JT
from deepviewagg_tpu_torch.data.collate import Bucket as TBucket
from deepviewagg_tpu_torch.data.datasets import tasks as TT
from torch_port_util import _torch_threads, assert_identical  # noqa: F401

SAME_ROWS = 0.99


def _write_off(path, seed, glued=False, quads=True):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (8, 3))
    faces = [[0, 1, 2], [2, 3, 4], [4, 5, 6]]
    if quads:
        faces.append([1, 3, 5, 7])
    head = (f"OFF{len(verts)} {len(faces)} 0\n" if glued
            else f"OFF\n{len(verts)} {len(faces)} 0\n")
    body = "".join(" ".join(f"{x:.6f}" for x in v) + "\n" for v in verts)
    body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n"
                    for f in faces)
    path.write_text(head + body)


@pytest.mark.parametrize("glued,quads", [(False, False), (True, True)])
def test_sample_off_mesh_is_the_jax_sampling(tmp_path, glued, quads):
    path = tmp_path / "m.off"
    _write_off(path, 1, glued, quads)
    for n, seed in ((64, 0), (1024, 5)):
        got = TT.sample_off_mesh(str(path), n, seed=seed)
        want = JT.sample_off_mesh(str(path), n, seed=seed)
        assert_identical(got, want)


@pytest.mark.parametrize("cls", range(len(JT.MODELNET_SYNTH_CLASSES)))
def test_procedural_shapes_are_the_jax_shapes(cls):
    assert TT.MODELNET_SYNTH_CLASSES == JT.MODELNET_SYNTH_CLASSES
    got = TT._synth_shape(cls, np.random.default_rng(cls), 300)
    want = JT._synth_shape(cls, np.random.default_rng(cls), 300)
    assert_identical(got, want)


def _modelnet(root):
    for ci, name in enumerate(("chair", "table", "lamp")):
        for split in ("train", "test"):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(2):
                _write_off(d / f"{name}_{i}.off", 10 * ci + i,
                           glued=i == 1)


@pytest.mark.parametrize("layout", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_classification_items_and_collate(tmp_path, layout, train):
    root = None
    if layout:
        _modelnet(tmp_path)
        root = str(tmp_path)
    kw = dict(n_points=256, voxel_size=0.1, samples_per_epoch=6)
    tds = TT.make_classification_dataset(root, train=train, **kw)
    jds = JT.make_classification_dataset(root, train=train, **kw)
    assert len(tds) == len(jds) == 6
    assert tuple(tds.classes) == tuple(jds.classes)
    assert tds.num_classes == (3 if layout else 8)
    items = [(tds[i], jds[i]) for i in range(3)]
    for got, want in items:
        assert_identical(got, want)
    caps = dict(level_caps=[1024, 1024, 512, 256, 128], num_batches=4)
    got = TT.collate_classification([g for g, _ in items], TBucket(**caps))
    want = JT.collate_classification([w for _, w in items], JBucket(**caps))
    assert_identical(got, want)
    assert (got["cls_label"][:3] >= 0).all() and got["cls_label"][3] == -1


def _scene_npz(root, n=2, panoptic=False):
    rng = np.random.default_rng(2)
    for i in range(n):
        m = 1500 + 100 * i
        arrays = {"pos": rng.uniform(0, 4, (m, 3)).astype(np.float32),
                  "rgb": rng.uniform(0, 1, (m, 3)).astype(np.float32)}
        if panoptic:
            arrays["labels"] = rng.integers(0, 4, m).astype(np.int32)
            arrays["instance"] = np.where(arrays["labels"] == 3,
                                          rng.integers(0, 3, m), -1
                                          ).astype(np.int32)
        else:
            arrays["boxes"] = np.concatenate(
                [rng.uniform(1, 3, (3, 3)), rng.uniform(0.4, 1.2, (3, 3))],
                1).astype(np.float32)
        np.savez(root / f"scene_{i:03d}.npz", **arrays)


def _same_graph(got, want, d2_atol=0.0):
    """Equal arrays but for the neighbour tables (held by share) and their
    squared distances (within ``d2_atol``)."""
    assert sorted(got) == sorted(want)
    for key in got:
        g, w = got[key], want[key]
        if key in ("group", "up_idx", "self_group"):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert (g == w).all(1).mean() >= SAME_ROWS, key
        elif key == "up_d2":
            np.testing.assert_allclose(g, w, rtol=0, atol=d2_atol)
        elif key == "group_count":
            assert g.dtype == w.dtype and (g == w).mean() >= SAME_ROWS
        elif isinstance(g, dict):
            _same_graph(g, w, d2_atol)
        elif isinstance(g, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                if isinstance(a, dict):
                    _same_graph(a, b, d2_atol)
                else:
                    assert_identical(a, b, key)
        else:
            assert_identical(g, w, key)


@pytest.mark.parametrize("layout", [False, True])
def test_detection_items(tmp_path, layout):
    root = None
    if layout:
        _scene_npz(tmp_path)
        root = str(tmp_path)
    kw = dict(n_points=1024, n_proposals=16)
    tds = TT.make_detection_dataset(root, train=True, **kw)
    jds = JT.make_detection_dataset(root, train=True, **kw)
    assert len(tds) == len(jds) == (2 if layout else 16)
    assert tds.num_classes == jds.num_classes == 2
    for i in (0, 1):
        got, want = tds[i], jds[i]
        assert sorted(got) == sorted(want)
        for key in ("feats", "valid", "gt_boxes"):
            assert_identical(got[key], want[key], key)
        # the expanded distances round at 4 ulps of the largest |p|^2
        d2_atol = 4 * np.finfo(np.float32).eps * float(
            (want["pn_graph"]["pos"][0] ** 2).sum(1).max())
        _same_graph(got["pn_graph"], want["pn_graph"], d2_atol)
        _same_graph(got["det_clusters"], want["det_clusters"])


@pytest.mark.parametrize("layout", [False, True])
def test_panoptic_items_and_collate(tmp_path, layout):
    root = None
    if layout:
        _scene_npz(tmp_path, panoptic=True)
        root = str(tmp_path)
    tds = TT.make_panoptic_dataset(root, train=True, voxel_size=0.3)
    jds = JT.make_panoptic_dataset(root, train=True, voxel_size=0.3)
    assert len(tds) == len(jds) == (2 if layout else 16)
    assert tds.thing_classes == jds.thing_classes == (3,)
    items = [(tds[i], jds[i]) for i in (0, 1)]
    for got, want in items:
        assert_identical(got, want)
        assert_identical(got.instance, want.instance)
    caps = dict(level_caps=[4096, 2048, 1024, 512, 256], num_batches=2)
    got = TT.collate_panoptic([g for g, _ in items], TBucket(**caps))
    want = JT.collate_panoptic([w for _, w in items], JBucket(**caps))
    assert_identical(got, want)
    # the second sample's ids come after the first sample's
    n0 = len(items[0][0].coords)
    second = got["instance"][n0: n0 + len(items[1][0].coords)]
    assert second[second >= 0].min() > items[0][0].instance.max()


def _pair_npz(root):
    rng = np.random.default_rng(3)
    for i, transform in enumerate((True, False)):
        pos_a = rng.uniform(0, 3, (700, 3)).astype(np.float32)
        arrays = {"pos_a": pos_a,
                  "pos_b": pos_a + rng.normal(0, 0.01, pos_a.shape
                                              ).astype(np.float32),
                  "pairs": np.stack([np.arange(700)] * 2, 1)}
        if transform:
            arrays["transform"] = np.eye(4, dtype=np.float32)
        np.savez(root / f"pair_{i:03d}.npz", **arrays)


@pytest.mark.parametrize("layout", [False, True])
def test_registration_items_and_collate(tmp_path, layout):
    root = None
    if layout:
        _pair_npz(tmp_path)
        root = str(tmp_path)
    kw = dict(n_points=512, voxel_size=0.15, max_pairs=128)
    tds = TT.make_registration_dataset(root, train=True, **kw)
    jds = JT.make_registration_dataset(root, train=True, **kw)
    assert len(tds) == len(jds) == (2 if layout else 8)
    caps = dict(level_caps=[1024, 1024, 512, 256, 128], num_batches=1)
    for i in (0, 1):
        got, want = tds[i], jds[i]
        assert_identical(got, want)
        assert got["pairs"].shape == (128, 2)
        assert_identical(TT.collate_registration(got, TBucket(**caps)),
                         JT.collate_registration(want, JBucket(**caps)))
