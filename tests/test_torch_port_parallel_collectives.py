"""The port's collectives, process mesh, multi-process input and sync batch
norm, in two spawned gloo ranks (``torch_port_parallel.Ranks``), against
the one-process computation they stand for.

Two ranks sum in one order either way (``a + b == b + a``), so the
all-reduce, the all-gather and their gradients must agree exactly with
autograd of the one-process equivalent; the sync batch norm sums rows in
another grouping than one process does, so it is held to float32 rounding.
The multi-process input mirrors ``test_multihost_distributed.py``: disjoint
halves of the sample stream with the runtime defaults, rank 0 alone
primary, an all-reduce equal to the host sum.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepviewagg_tpu_torch.cli.train import shard_batches
from deepviewagg_tpu_torch.nn.norm import MaskedBatchNorm
from deepviewagg_tpu_torch.parallel import mesh as pmesh
from deepviewagg_tpu_torch.parallel import multihost
from torch_port_parallel import Ranks
from torch_port_util import _torch_threads  # noqa: F401

WORLD = 2


def _bn_inputs():
    rng = np.random.default_rng(3)
    rows = [rng.normal(1.0, 2.0, size=(n, 6)).astype(np.float32)
            for n in (9, 14)]
    valid = [rng.random(len(r)) < 0.8 for r in rows]
    return {"bn_rows": rows, "bn_valid": valid,
            "bn_weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bn_cot": [rng.normal(size=r.shape).astype(np.float32)
                       for r in rows]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _bn_inputs()
    run = Ranks(WORLD, ["collectives"], tmp_path_factory.mktemp("coll"),
                inputs)
    return run.wait()["collectives"], inputs


def _seeded(rank):
    rng = np.random.default_rng(10 + rank)
    x = torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32)
    xg = torch.tensor(rng.normal(size=(2, 3, 4)), dtype=torch.float32,
                      requires_grad=True)
    wg = torch.tensor(rng.normal(size=(2 * WORLD, 3, 4)), dtype=torch.float32)
    return x, w, xg, wg, rng


def test_all_reduce_sum_and_its_gradient_are_exact(ranks):
    got, _ = ranks
    xs, ws = zip(*[_seeded(r)[:2] for r in range(WORLD)])
    y = xs[0] + xs[1]
    sum((y * w).sum() for w in ws).backward()
    for r in range(WORLD):
        y_r, g_r = got[r]["sum"]
        np.testing.assert_array_equal(y_r, y.detach().numpy())
        np.testing.assert_array_equal(g_r, xs[r].grad.numpy())


def test_all_gather_blocks_and_its_gradient_are_exact(ranks):
    got, _ = ranks
    seeded = [_seeded(r) for r in range(WORLD)]
    xs = [s[2] for s in seeded]
    y = torch.cat(xs)
    sum((y * s[3]).sum() for s in seeded).backward()
    for r in range(WORLD):
        y_r, g_r = got[r]["gather"]
        np.testing.assert_array_equal(y_r, y.detach().numpy())
        # each block's cotangent summed over the ranks (a reduce-scatter)
        np.testing.assert_array_equal(g_r, xs[r].grad.numpy())


def test_bucketed_mean_and_broadcast(ranks):
    got, _ = ranks
    before = [got[r]["mean"][0] for r in range(WORLD)]
    for r in range(WORLD):
        for i, t in enumerate(got[r]["mean"][1]):
            want = (before[0][i] + before[1][i]) / 2
            assert t.dtype == before[0][i].dtype
            np.testing.assert_array_equal(t, want)
        for t in got[r]["broadcast"]:
            assert (t == 1.0).all()


def test_multihost_shards_disjoint_halves(ranks):
    got, _ = ranks
    assert [got[r]["primary"] for r in range(WORLD)] == [True, False]
    assert got[0]["shard"] == [0, 2, 4, 6] and got[1]["shard"] == [1, 3, 5, 7]
    # both ranks agree on the sum over every sample: sum(i * 4 for i < 8)
    assert got[0]["total"] == got[1]["total"] == float(sum(
        i * 4 for i in range(8)))


def test_mesh_groups(ranks):
    got, _ = ranks
    # 1 x 2: the model axis minor, every rank its own data group
    for r in range(WORLD):
        n_data, n_model, d, m, data_ranks, model_ranks = got[r]["hybrid_mesh"]
        assert (n_data, n_model, d, m) == (1, 2, 0, r)
        assert data_ranks == [r] and model_ranks == [0, 1]
        assert got[r]["mesh"] == (2, 1, r, True)


def test_sync_batch_norm_equals_one_process_on_all_rows(ranks):
    got, inputs = ranks
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(inputs["bn_weight"]))
    x = torch.tensor(np.concatenate(inputs["bn_rows"]), requires_grad=True)
    y = bn(x, torch.tensor(np.concatenate(inputs["bn_valid"])))
    (y * torch.tensor(np.concatenate(inputs["bn_cot"]))).sum().backward()
    split = len(inputs["bn_rows"][0])
    for r, rows in enumerate((slice(0, split), slice(split, None))):
        y_r, gx_r, gw_r, mean_r, var_r = got[r]["bn"]
        np.testing.assert_allclose(y_r, y.detach().numpy()[rows],
                                   rtol=1e-5, atol=1e-5)
        # the backward of the summed statistics reaches every rank's rows
        np.testing.assert_allclose(gx_r, x.grad.numpy()[rows],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(mean_r, bn.running_mean.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var_r, bn.running_var.numpy(),
                                   rtol=1e-5, atol=1e-6)
    # each rank's weight gradient is its own rows' share
    np.testing.assert_allclose(got[0]["bn"][2] + got[1]["bn"][2],
                               bn.weight.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_fold_in_keeps_index_zero_and_separates_the_others():
    g = torch.Generator().manual_seed(5)
    assert pmesh.fold_in(g, 0) is g and pmesh.fold_in(None, 3) is None

    def draws(index):
        g = torch.Generator().manual_seed(5)
        return [torch.rand(4, generator=pmesh.fold_in(g, index))
                for _ in range(2)]

    a, b, c = draws(1), draws(1), draws(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])               # a new draw each step
    assert not any(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("n_batches,n_data,taken", [
    (7, 2, ([0, 2, 4], [1, 3, 5])),
    (6, 3, ([0, 3], [1, 4], [2, 5])),
    (4, 1, ([0, 1, 2, 3],)),
])
def test_shard_batches_is_chunk_per_device(n_batches, n_data, taken):
    for r, want in enumerate(taken):
        assert list(shard_batches(iter(range(n_batches)), n_data, r)) == want


def test_shard_batches_refuses_an_epoch_shorter_than_the_shards():
    with pytest.raises(ValueError, match="produced 1 batch"):
        list(shard_batches(iter(range(1)), 2, 0))
    assert list(shard_batches(iter(()), 2, 1)) == []


def test_world_of_one_and_runtime_defaults():
    assert multihost.is_primary() and not dist.is_initialized()
    loader = multihost.HostShardedLoader(lambda: iter(range(3)))
    assert (loader.pi, loader.pc, list(loader)) == (0, 1, [0, 1, 2])
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.make_mesh()
    assert multihost.initialize(device="cpu")
    try:
        assert not multihost.initialize(device="cpu")     # up already
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = pmesh.make_mesh()
        assert (mesh.n_data, mesh.n_model, mesh.rank) == (1, 1, 0)
        with pytest.raises(ValueError, match="must divide"):
            pmesh.make_hybrid_mesh(2)
        batch = {"x": np.arange(3, dtype=np.float32), "meta": {"n": 3}}
        got = multihost.global_device_batch([batch], "cpu")
        assert list(got) == ["x"] and torch.equal(got["x"], torch.arange(3.0))
        bn = MaskedBatchNorm(2)
        assert pmesh.replicate(bn, mesh) is bn
        host = pmesh.unreplicate(bn)
        assert sorted(host) == ["bias", "running_mean", "running_var",
                                "weight"]
        assert all(isinstance(v, np.ndarray) for v in host.values())
    finally:
        dist.destroy_process_group()
