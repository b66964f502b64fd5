"""The port's ``ops/knn.py::radius_count`` and ``dilated_knn`` against the
JAX package's, on the same numpy inputs.

``radius_count`` compares the expanded squared distance with ``r^2`` in
both packages; the two matmuls sum in another order, so a point within a
rounding of the sphere could be counted by one package only.  The inputs
here lie on a grid of 1/16 and ``r^2`` halfway between two multiples of
1/256, so every squared distance is at least 1/512 from ``r^2`` (checked in
float64; the float32 error of the expanded form is below 1e-5 here), and
the counts are then equal.
``dilated_knn`` draws its pick from the numpy ``Generator`` it is given,
as the JAX package does: from one ``Generator`` state the two give the same
neighbours and distances (the candidate lists are equal on these inputs,
which hold no two candidates at a tied distance).
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.ops import knn as jknn
from deepviewagg_tpu_torch.ops import knn as tknn
from torch_port_util import _torch_threads  # noqa: F401

MARGIN = 1.0 / 512     # |d^2 - r^2| of every (query, point) pair, float64


def _cloud(seed, n, q, masked=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    query = rng.uniform(0, 2, (q, 3)).astype(np.float32)
    valid = rng.uniform(size=n) >= masked
    return query, pos, valid


def _grid_cloud(seed, n, q, radius, masked):
    """Points and queries on a grid of 1/16 in [0, 2]^3, and the radius
    nearest ``radius`` whose square lies halfway between two multiples of
    1/256."""
    rng = np.random.default_rng(seed)
    pos = (rng.integers(0, 33, (n, 3)) / 16).astype(np.float32)
    query = (rng.integers(0, 33, (q, 3)) / 16).astype(np.float32)
    valid = rng.uniform(size=n) >= masked
    r = float(np.sqrt((np.floor(radius * radius * 256) + 0.5) / 256))
    return query, pos, valid, r


def _margin(query, pos, radius):
    d = ((query[:, None, :].astype(np.float64) - pos[None]) ** 2).sum(-1)
    return float(np.abs(d - radius * radius).min())


@pytest.mark.parametrize("radius,masked,block", [
    (0.2, 0.0, 1024), (0.35, 0.2, 64), (0.6, 0.1, 100)])
def test_radius_count_matches_jax(radius, masked, block):
    query, pos, valid, radius = _grid_cloud(int(radius * 100), 700, 300,
                                            radius, masked)
    assert _margin(query, pos, radius) >= MARGIN
    want = jknn.radius_count(query, pos, radius, valid=valid, block=block)
    got = tknn.radius_count(torch.from_numpy(query), torch.from_numpy(pos),
                            radius, valid=torch.from_numpy(valid),
                            block=block)
    assert got.dtype == torch.int64 and got.shape == (300,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1
    # no mask: every point counts
    want = jknn.radius_count(query, pos, radius, block=block)
    got = tknn.radius_count(torch.from_numpy(query), torch.from_numpy(pos),
                            radius, block=block)
    np.testing.assert_array_equal(got.numpy(), want)


def test_radius_count_without_queries():
    got = tknn.radius_count(torch.zeros((0, 3)), torch.ones((5, 3)), 0.5)
    assert got.shape == (0,) and got.dtype == torch.int64


@pytest.mark.parametrize("k,dilation,masked", [(8, 4, 0.0), (6, 3, 0.2),
                                               (4, 2, 0.1)])
def test_dilated_knn_matches_jax(k, dilation, masked):
    query, pos, valid = _cloud(k, 800, 200, masked)
    jd, ji = jknn.dilated_knn(query, pos, k, dilation, valid=valid,
                              rng=np.random.default_rng(5))
    td, ti = tknn.dilated_knn(torch.from_numpy(query), torch.from_numpy(pos),
                              k, dilation, valid=torch.from_numpy(valid),
                              rng=np.random.default_rng(5))
    assert ti.shape == td.shape == (200, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-5)
    # a pick of k distinct valid points among the k * dilation nearest
    _, ring = tknn.knn(torch.from_numpy(query), torch.from_numpy(pos),
                       k * dilation, valid=torch.from_numpy(valid))
    for row, full in zip(ti.numpy(), ring.numpy()):
        assert len(set(row)) == k and set(row) <= set(full)
    assert valid[ti.numpy()].all()
    # another generator state picks another subset
    _, other = tknn.dilated_knn(torch.from_numpy(query),
                                torch.from_numpy(pos), k, dilation,
                                valid=torch.from_numpy(valid),
                                rng=np.random.default_rng(6))
    assert not torch.equal(other, ti)


def test_dilated_knn_needs_a_generator_and_reduces_to_knn():
    query, pos, _ = _cloud(0, 300, 50)
    q, p = torch.from_numpy(query), torch.from_numpy(pos)
    with pytest.raises(ValueError, match="Generator"):
        tknn.dilated_knn(q, p, 4, 2)
    with pytest.raises(ValueError):
        jknn.dilated_knn(query, pos, 4, 2)
    for dilation in (1, 0):
        d, i = tknn.dilated_knn(q, p, 5, dilation)
        want_d, want_i = tknn.knn(q, p, 5)
        assert torch.equal(i, want_i) and torch.equal(d, want_d)
        jd, ji = jknn.dilated_knn(query, pos, 5, dilation)
        np.testing.assert_array_equal(i.numpy(), ji)
