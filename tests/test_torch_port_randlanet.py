"""The port's RandLA-Net (``nn/randlanet.py``) against the JAX package's:
``build_randla_graph`` on the same cloud, ``_AttentivePool`` alone and
``RandLANetSeg`` whole on the JAX builder's graph, from the same converted
flax variables.

The builder draws its centres with the same numpy ``Generator`` calls and
takes its kNN tables from each package's ``knn`` on the CPU: the centres,
masks and neighbour indices are equal (no two candidates lie at a tied
distance in these clouds); the squared distances come from the expanded
form ``|q|^2 + |p|^2 - 2 q.p``, whose matmul sums in another order in each
package, and agree to 1e-5 absolute (3.8e-6 measured).  The model is
float32 throughout: 1e-5 of the largest magnitude for a layer, 1e-4 for
the model (ROADMAP C).
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import randlanet as jrl
from deepviewagg_tpu_torch.nn import randlanet as trl
from torch_port_backbones import (assert_layer_close, assert_model_close,
                                  assert_same_tree, layer_runs, model_runs)
from torch_port_util import _torch_threads  # noqa: F401

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
D2_ATOL = 1e-5
CHANNELS = (16, 32)


def _cloud(n=1000, seed=4, masked=40, samples=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-masked:] = False
    batch_idx = (np.arange(n) * samples // n).astype(np.int32)
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    return pos, batch_idx, valid, feats, rng.integers(0, 5, n).astype(
        np.int32)


@pytest.mark.parametrize("decimation,num_levels,k,seed", [
    (4, 2, 12, 0), (3, 3, 8, 7)])
def test_build_randla_graph_matches_jax(decimation, num_levels, k, seed):
    pos, batch_idx, valid, _, _ = _cloud(seed=seed + 1)
    kw = dict(decimation=decimation, num_levels=num_levels, k=k, seed=seed)
    jg = jrl.build_randla_graph(pos, batch_idx, valid, **kw)
    tg = trl.build_randla_graph(pos, batch_idx, valid, **kw)
    assert len(tg["pos"]) == len(jg["pos"]) == num_levels + 1
    for a, b in zip(tg["pos"], jg["pos"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for tl, jl in zip(tg["levels"], jg["levels"]):
        assert sorted(tl) == sorted(jl)
        for key in jl:
            assert tl[key].dtype == jl[key].dtype, key
            assert tl[key].shape == jl[key].shape, key
        for key in ("nbr", "centers", "center_valid", "up_idx"):
            np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
        for key in ("nbr_d2", "up_d2"):
            np.testing.assert_allclose(tl[key], jl[key], rtol=0,
                                       atol=D2_ATOL, err_msg=key)
    # decimation draws among valid points only
    assert tg["levels"][0]["center_valid"].all()


def test_attentive_pool_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(120, 9, 14)).astype(np.float32)
    cot = rng.normal(size=(120, 16)).astype(np.float32)
    got, want = layer_runs(jrl._AttentivePool(16),
                           trl._AttentivePool(14, 16, device="cpu"), (x,),
                           cot, has_train=False)
    assert_layer_close(got, want, LAYER_RTOL)


@pytest.fixture(scope="module")
def runs():
    pos, batch_idx, valid, feats, labels = _cloud()
    graph = jrl.build_randla_graph(pos, batch_idx, valid, num_levels=2, k=12)
    batch = {"rl_graph": graph, "feats": feats, "valid": valid}
    got, want = model_runs(
        jrl.RandLANetSeg(5, channels=CHANNELS),
        trl.RandLANetSeg(5, 4, channels=CHANNELS, device="cpu", seed=None),
        batch, labels, valid)
    return got, want, batch


def test_randlanet_seg_matches_jax(runs):
    got, want, batch = runs
    assert got["logits"].shape == want["logits"].shape == (1000, 5)
    assert_model_close(got, want, batch["valid"], MODEL_RTOL)


def test_seeded_init_under_the_flax_names(runs):
    batch = runs[2]
    make = lambda: trl.RandLANetSeg(5, 4, channels=CHANNELS,  # noqa: E731
                                    device="cpu", seed=5)
    a, b = make(), make()
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert_same_tree(a, jrl.RandLANetSeg(5, channels=CHANNELS), batch,
                     train=False)
