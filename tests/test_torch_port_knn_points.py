"""The per-sample exact kNN of ``ops/knn.py`` on the CPU: the brute force
:func:`knn_points_plain` (what ``knn_points`` runs on a CPU tensor)
against a numpy brute force with the same float32 arithmetic and tie rule,
and the kernel's ring search written out (``knn_clouds.rings``) against
the brute force, on clouds with repeated points, uneven samples, samples
below ``k``, planes and far outliers.  All exact: the same rows."""

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.ops import knn as K
from knn_clouds import brute, cells, cloud, rings

SIZES = [300, 3, 0, 211, 17, 1, 8]


@pytest.mark.parametrize("k", [8, 16, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_the_numpy_brute_force(seed, k):
    pos, off = cloud(seed, SIZES)
    idx = K.knn_points_plain(pos, off, k, chunk=64)
    assert np.array_equal(idx.numpy(), brute(pos, off, k))
    assert torch.equal(K.knn_points(pos, off, k), idx)


def test_rows_first_themselves_then_ties_by_row():
    pos, off = cloud(2, [120])
    idx = K.knn_points_plain(pos, off, 4)
    dup = torch.nonzero((pos[:, None] == pos[None]).all(-1).sum(1) > 1)[:, 0]
    assert dup.numel() > 0
    for r in range(120):
        twins = [int(j) for j in dup if torch.equal(pos[j], pos[r])]
        if twins:
            assert idx[r, :len(twins)].tolist() == sorted(twins)[:4]
        else:
            assert int(idx[r, 0]) == r


def test_small_samples_pad_with_minus_one():
    pos, off = cloud(3, [3, 0, 1, 20])
    idx = K.knn_points_plain(pos, off, 8)
    assert (idx[:3, 3:] == -1).all() and (idx[:3, :3] >= 0).all()
    assert (idx[3, 1:] == -1).all() and int(idx[3, 0]) == 3
    assert (idx[4:] >= 4).all()


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("seed", [0, 4])
def test_ring_search_equals_the_brute_force(seed, k):
    pos, off = cloud(seed, SIZES)
    assert torch.equal(rings(pos, off, k),
                       K.knn_points_plain(pos, off, k))


def test_ring_search_on_a_plane_beside_a_far_point():
    # one ring of cells holds no neighbour of the lone point: the search
    # falls back to the whole sample; the plane's points stop after rings
    # that their own distances set
    g = np.stack(np.meshgrid(np.arange(30), np.arange(30)), -1)
    plane = np.concatenate([g.reshape(-1, 2) * 0.02,
                            np.zeros((900, 1))], 1).astype(np.float32)
    pos = torch.from_numpy(np.concatenate(
        [plane, np.array([[3.0, 3.0, 1.0]], np.float32)]))
    off = torch.tensor([0, 901], dtype=torch.int32)
    assert torch.equal(rings(pos, off, 16),
                       K.knn_points_plain(pos, off, 16))


def test_cell_grid_bounds_the_cells_a_side():
    pos, off = cloud(5, [400, 2, 0])
    sample = K._sample_ids(off, pos.shape[0])
    lo, h, ncell = K.cell_grid(pos, sample, off, 16)
    assert (h > 0).all() and (ncell >= 1).all()
    assert int(ncell.max()) <= K.MAX_CELLS + 1
    c = cells(pos, sample, lo, h, ncell)
    assert (c >= 0).all() and (c < ncell[sample.long()]).all()


def test_arguments_are_checked():
    pos, off = cloud(0, [10])
    with pytest.raises(TypeError):
        K.knn_points(pos.double(), off, 4)
    with pytest.raises(TypeError):
        K.knn_points(pos, off.long(), 4)
    with pytest.raises(ValueError):
        K.knn_points(pos, off, K.KERNEL_K + 1)
