"""The per-sample kNN kernel on the card (``csrc/knn.cu``, through
``ops/knn.py::knn_points``) against the brute force (marker ``card``; they
skip without CUDA).

Exact: the kernel's table equals :func:`knn_points_plain`'s (and the numpy
brute force's) row for row, the tie rule (the lower row) included, on
clouds with repeated points, uneven samples, an empty sample, samples below
``k``, planes and far outliers (whose search falls back to the whole
sample), for ``k`` of 16 (the kernel's width), 8 and 5 (its first columns);
then at the PTv2 cell's level 0 (12 crops of 102,400 points of the
synthetic rooms) on a subset of queries.  The file imports no JAX, so that the card's machine runs it as
it is::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_knn_card.py -q -m card
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepviewagg_tpu_torch.ops import knn as K  # noqa: E402
from knn_clouds import brute, cloud  # noqa: E402
from torch_port_util import card  # noqa: E402,F401

SIZES = [3000, 3, 0, 2111, 17, 1, 8, 500]


@pytest.mark.card
@pytest.mark.parametrize("k", [8, 16, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_knn_equals_the_brute_force(card, seed, k):
    pos, off = cloud(seed, SIZES)
    want = K.knn_points_plain(pos, off, k)
    launches = K.LAUNCHES["knn"]
    idx = K.knn_points(pos.to(card), off.to(card), k)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn"] == launches + 2
    assert idx.dtype == torch.int32 and idx.shape == (pos.shape[0], k)
    assert torch.equal(idx.cpu(), want)


@pytest.mark.card
def test_card_knn_all_points_equal_and_a_lone_point(card):
    pos = torch.zeros((40, 3))
    pos[39] = torch.tensor([5.0, 0.0, 0.0])
    off = torch.tensor([0, 30, 39, 40], dtype=torch.int32)
    want = K.knn_points_plain(pos, off, 16)
    got = K.knn_points(pos.to(card), off.to(card), 16).cpu()
    assert torch.equal(got, want)
    assert got[0, :16].tolist() == list(range(16))
    assert (got[39, 1:] == -1).all() and int(got[39, 0]) == 39


def _room_crops(rng, crops=12, points=102400):
    """Crops of the ``points`` nearest points of random centres of a 6 x 4
    x 2.6 m room's floor, ceiling and two walls at the 2 cm grid, jittered
    by 3 mm."""
    xs = np.arange(0, 6, 0.02, dtype=np.float32)
    ys = np.arange(0, 4, 0.02, dtype=np.float32)
    zs = np.arange(0, 2.6, 0.02, dtype=np.float32)
    fl = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    wall = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
    room = np.concatenate([
        np.c_[fl, np.zeros(len(fl))], np.c_[fl, np.full(len(fl), 2.6)],
        np.c_[wall[:, 0], np.zeros(len(wall)), wall[:, 1]],
        np.c_[wall[:, 0], np.full(len(wall), 4.0), wall[:, 1]]])
    room = (room + rng.normal(0, 0.003, room.shape)).astype(np.float32)
    parts = []
    for _ in range(crops):
        d = ((room - room[rng.integers(len(room))]) ** 2).sum(1)
        parts.append(room[np.argsort(d)[:points]])
    return torch.from_numpy(np.concatenate(parts))


@pytest.mark.card
@pytest.mark.parametrize("k", [8, 16])
def test_card_knn_at_the_ptv2_cells_level_zero(card, k):
    rng = np.random.default_rng(2101)
    pos = _room_crops(rng)
    off = torch.arange(0, 12 * 102400 + 1, 102400, dtype=torch.int32)
    idx = K.knn_points(pos.to(card), off.to(card), k)
    rows = np.sort(rng.choice(len(pos), 4000, replace=False))
    assert np.array_equal(idx.cpu().numpy()[rows], brute(pos, off, k, rows))
