"""The port's spatial ops (``ops/spatial.py``) and the pointnet graph builder
against the JAX package's, on the same numpy inputs.

FPS takes direct differences in float32 in both packages: the centres are
equal, index for index, also on a graph of two samples shifted 1e4 apart.
Ball queries and kNN read the expanded distance ``|q|^2 + |p|^2 - 2 q.p``,
whose matmul sums in another order in each package: neighbours at equal
distance may swap and a point may cross the radius by a rounding, so the
tables are held as the share of identical rows (all of them on these
inputs, at least 99% required) with the counts equal.  kNN interpolation
weighs by ``1 / d^2`` of that expanded form, where the nearest neighbours'
distances cancel: the values agree to 5e-4 of the largest magnitude (1.2e-4
and 1.8e-4 measured on these inputs).

On a graph of two samples, sample 1 sits 1e4 away, where the float32
spacing of ``|q|^2`` is 8: every distance under about 2.8 units reads 0 in
both packages (ROADMAP C), so its ball queries are ties in arbitrary order
and only the centres are compared there.
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import pointnet2 as jpn
from deepviewagg_tpu.ops import spatial as jsp
from deepviewagg_tpu_torch.nn import pointnet2 as tpn
from deepviewagg_tpu_torch.ops import spatial as tsp
from torch_port_util import _torch_threads, rel_err  # noqa: F401

SAME_ROWS = 0.99
INTERP_RTOL = 5e-4


def _cloud(seed, n, masked=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) >= masked
    return pos, valid


@pytest.mark.parametrize("n,m,masked,start", [
    (300, 32, 0.0, 0), (500, 64, 0.1, 3), (2000, 256, 0.3, 17)])
def test_farthest_point_sample_matches_jax(n, m, masked, start):
    pos, valid = _cloud(n, n, masked)
    want = np.asarray(jsp.farthest_point_sample(pos, m, valid, start=start))
    got = tsp.farthest_point_sample(pos, m, valid, start=start)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert valid[got.numpy()[1:]].all()
    # the default mask (every point valid) and tensor inputs
    want = np.asarray(jsp.farthest_point_sample(pos, m))
    got = tsp.farthest_point_sample(torch.from_numpy(pos), m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius,k,masked", [(0.3, 8, 0.0), (0.4, 16, 0.1),
                                              (0.05, 4, 0.2)])
def test_ball_query_matches_jax(radius, k, masked):
    pos, valid = _cloud(11, 1500, masked)
    q = pos[np.asarray(jsp.farthest_point_sample(pos, 200, valid))]
    j_idx, j_cnt = jsp.ball_query(q, pos, radius, k, valid=valid)
    t_idx, t_cnt = tsp.ball_query(q, pos, radius, k, valid=valid)
    assert t_idx.dtype == torch.int32 and t_cnt.dtype == torch.int32
    assert (t_idx.numpy() == j_idx).all(1).mean() >= SAME_ROWS
    np.testing.assert_array_equal(t_cnt.numpy(), j_cnt)
    # the semantics on the port's own table: hits within the radius in the
    # first ``count`` slots, the first hit repeated after them
    idx, cnt = t_idx.numpy().astype(np.int64), t_cnt.numpy()
    d2 = ((pos[idx] - q[:, None]) ** 2).sum(-1)
    slot = np.arange(k)[None, :]
    assert (d2[slot < cnt[:, None]] <= radius ** 2 + 1e-5).all()
    assert (idx[slot >= np.maximum(cnt, 1)[:, None]]
            == np.broadcast_to(idx[:, :1], idx.shape)[
                slot >= np.maximum(cnt, 1)[:, None]]).all()
    assert valid[idx[slot < cnt[:, None]]].all()


def test_knn_interpolate_matches_jax():
    pos, valid = _cloud(5, 800)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(800, 5)).astype(np.float32)
    dst = rng.uniform(0, 3, (300, 3)).astype(np.float32)
    for k, v in ((3, None), (1, valid), (5, valid)):
        want = np.asarray(jsp.knn_interpolate(feats, pos, dst, k=k, valid=v))
        got = tsp.knn_interpolate(torch.from_numpy(feats), pos, dst, k=k,
                                  valid=v)
        assert got.shape == want.shape
        assert rel_err(got.numpy(), want) <= INTERP_RTOL


def test_multiscale_ball_query_matches_jax():
    pos, valid = _cloud(8, 600)
    q = pos[:50]
    want = jsp.multiscale_ball_query(q, pos, [0.2, 0.5], [4, 12], valid=valid)
    got = tsp.multiscale_ball_query(q, pos, [0.2, 0.5], [4, 12], valid=valid)
    assert len(got) == len(want) == 2
    for (ti, tc), (ji, jc) in zip(got, want):
        assert (ti.numpy() == ji).all(1).mean() >= SAME_ROWS
        np.testing.assert_array_equal(tc.numpy(), jc)
    # a scalar radius and k
    (ti, tc), = tsp.multiscale_ball_query(q, pos, 0.3, 6)
    (ji, jc), = jsp.multiscale_ball_query(q, pos, 0.3, 6)
    np.testing.assert_array_equal(tc.numpy(), jc)
    with pytest.raises(ValueError):
        tsp.multiscale_ball_query(q, pos, [0.2, 0.5], [4])


def _graphs(batch_idx, self_k=0):
    pos, _ = _cloud(21, len(batch_idx))
    valid = np.ones(len(pos), bool)
    valid[-40:] = False
    kw = dict(n_points=(256, 64), radii=(0.3, 0.6), k=16, self_k=self_k)
    return (jpn.build_pointnet_graph(pos, batch_idx, valid, **kw),
            tpn.build_pointnet_graph(pos, batch_idx, valid, **kw))


@pytest.mark.parametrize("self_k", [0, 6])
def test_one_sample_graph_matches_jax(self_k):
    jg, tg = _graphs(np.zeros(1500, np.int32), self_k)
    assert len(tg["pos"]) == len(jg["pos"]) == 3
    for a, b in zip(tg["pos"], jg["pos"]):
        np.testing.assert_array_equal(a, b)
    for tl, jl in zip(tg["levels"], jg["levels"]):
        assert sorted(tl) == sorted(jl)
        for key in jl:
            assert tl[key].dtype == jl[key].dtype, key
            assert tl[key].shape == jl[key].shape, key
        for key in ("centers", "center_valid", "group_count"):
            np.testing.assert_array_equal(tl[key], jl[key])
        for key in ("group", "up_idx") + (("self_group",) if self_k else ()):
            assert (tl[key] == jl[key]).all(1).mean() >= SAME_ROWS, key
        if self_k:
            np.testing.assert_array_equal(tl["self_count"], jl["self_count"])
        np.testing.assert_allclose(tl["up_d2"], jl["up_d2"], atol=1e-5)


def test_two_sample_graph_keeps_the_fps_centres():
    jg, tg = _graphs((np.arange(1500) >= 700).astype(np.int32))
    for tl, jl in zip(tg["levels"], jg["levels"]):
        np.testing.assert_array_equal(tl["centers"], jl["centers"])
        np.testing.assert_array_equal(tl["center_valid"], jl["center_valid"])
    # both packages shift sample b by b * 1e4, in float32
    np.testing.assert_array_equal(tg["pos"][0], jg["pos"][0])
    assert tg["pos"][0][-1, 0] > 1e4 - 1
