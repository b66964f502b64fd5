"""The port's PointNet++ module (``nn/pointnet2.py``) against the JAX
package's: ``_PointMLP`` alone and ``PointNet2Seg`` whole, from the same
converted flax variables, on one graph built by the JAX package and moved
as it is (so that both models read the same tables: the graph builders
themselves are held in ``test_torch_port_spatial.py``).

Everything is float32 (dense layers and masked batch norms, no bf16
operand): ``_PointMLP`` agrees to 1e-5 of the largest magnitude (output,
input and parameter gradients, running statistics); the whole net's logits,
loss, gradients and running statistics to 1e-4 (ROADMAP C's bounds for a
module and for a model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import pointnet2 as jpn
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.nn import pointnet2 as tpn
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, backward_node_names,  # noqa: F401
                             flat_leaves, jax_variables, rel_err)

MODULE_RTOL = 1e-5
MODEL_RTOL = 1e-4
SA = ((16, 32), (32, 64))
FP = ((32, 32), (64, 32))


def _batch(n=900, classes=5):
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-50:] = False
    graph = jpn.build_pointnet_graph(pos, np.zeros(n, np.int32), valid,
                                     n_points=(128, 32), radii=(0.4, 0.8),
                                     k=12)
    return {"pn_graph": graph,
            "feats": rng.normal(size=(n, 4)).astype(np.float32),
            "valid": valid}, rng.integers(0, classes, n).astype(np.int32)


def _leaf_errs(got, want):
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want)
    return {k: rel_err(got[k], want[k]) for k in want}


@pytest.mark.parametrize("train", [True, False])
def test_point_mlp_matches_jax(train):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 7)).astype(np.float32)
    valid = rng.uniform(size=400) > 0.2
    cot = rng.normal(size=(400, 16)).astype(np.float32)
    jmod = jpn._PointMLP((8, 16))
    variables = jax_variables(jmod, x, valid, train=False, seed=1)

    def loss(params, x):
        out, new = jmod.apply(dict(variables, params=params), x, valid,
                              train=train, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new)

    (_, (j_out, j_new)), (j_gp, j_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)

    tmod = tpn._PointMLP(7, (8, 16), device="cpu")
    load_flax_variables(tmod, variables)
    tmod.train(train)
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx, torch.from_numpy(valid))
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_err(out.detach().numpy(), j_out) <= MODULE_RTOL
    assert rel_err(tx.grad.numpy(), j_gx) <= MODULE_RTOL
    errs = _leaf_errs(to_flax_tree(tmod, "grads"), jax.device_get(j_gp))
    assert max(errs.values()) <= MODULE_RTOL, errs
    errs = _leaf_errs(to_flax_tree(tmod, "batch_stats"),
                      jax.device_get(j_new["batch_stats"]))
    assert max(errs.values()) <= MODULE_RTOL, errs


@pytest.fixture(scope="module")
def runs():
    """Both nets on one batch: eval-mode logits, then in train mode the
    logits, the masked CE loss, its gradients and the running statistics
    after the pass."""
    batch, labels = _batch()
    jmodel = jpn.PointNet2Seg(num_classes=5, sa_channels=SA, fp_channels=FP)
    variables = jax_variables(jmodel, batch, train=False, seed=2)
    valid = batch["valid"]

    def loss(params):
        out, new = jmodel.apply(dict(variables, params=params), batch,
                                train=True, mutable=["batch_stats"])
        lp = jax.nn.log_softmax(out["logits"])
        ll = jnp.take_along_axis(lp, labels[:, None], 1)[:, 0]
        return -jnp.sum(jnp.where(valid, ll, 0.0)) / valid.sum(), (out, new)

    (j_loss, (j_out, j_new)), j_grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    j_eval = jmodel.apply(variables, batch, train=False)["logits"]

    tmodel = tpn.PointNet2Seg(5, 4, sa_channels=SA, fp_channels=FP,
                              device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    tb = batch_to_torch(batch, "cpu")
    # eval first: the train-mode pass updates the running statistics
    tmodel.eval()
    with torch.no_grad():
        t_eval = tmodel(tb)["logits"].numpy()
    tmodel.train()
    logits = tmodel(tb)["logits"]
    lp = torch.log_softmax(logits, -1)
    ll = torch.gather(lp, 1, torch.from_numpy(labels).long()[:, None])[:, 0]
    t_loss = -torch.sum(torch.where(tb["valid"], ll, 0.0)) / tb["valid"].sum()
    t_loss.backward()
    got = {"loss": float(t_loss.detach()), "logits": logits.detach().numpy(),
           "grads": to_flax_tree(tmodel, "grads"),
           "stats": to_flax_tree(tmodel, "batch_stats"),
           "nodes": backward_node_names(logits), "eval": t_eval}
    want = {"loss": float(j_loss), "logits": np.asarray(j_out["logits"]),
            "grads": jax.device_get(j_grads),
            "stats": jax.device_get(j_new["batch_stats"]),
            "eval": np.asarray(j_eval)}
    return got, want, valid


def test_pointnet2_logits_match_jax(runs):
    got, want, valid = runs
    assert got["logits"].shape == want["logits"].shape == (900, 5)
    assert rel_err(got["logits"][valid], want["logits"][valid]) <= MODEL_RTOL
    assert rel_err(got["eval"][valid], want["eval"][valid]) <= MODEL_RTOL


def test_pointnet2_loss_and_gradients_match_jax(runs):
    got, want, _ = runs
    assert abs(got["loss"] - want["loss"]) <= MODEL_RTOL * abs(want["loss"])
    errs = _leaf_errs(got["grads"], want["grads"])
    assert max(errs.values()) <= MODEL_RTOL, errs


def test_pointnet2_running_statistics_match_jax(runs):
    got, want, _ = runs
    errs = _leaf_errs(got["stats"], want["stats"])
    assert max(errs.values()) <= MODEL_RTOL, errs


def test_groups_are_gathered_by_index_select(runs):
    """The SA groups' and the FP upsampling's rows come by ``index_select``
    (an ``index_add_`` backward), never by ``x[group]`` (``index_put_``
    with accumulate, which sorts)."""
    nodes = runs[0]["nodes"]
    assert "IndexSelectBackward0" in nodes
    assert not any(n.startswith(("IndexBackward", "IndexPutBackward"))
                   for n in nodes), sorted(set(nodes))


def test_seeded_init_is_reproducible_under_the_flax_names():
    a = tpn.PointNet2Seg(3, 4, sa_channels=SA, fp_channels=FP, device="cpu",
                         seed=7)
    b = tpn.PointNet2Seg(3, 4, sa_channels=SA, fp_channels=FP, device="cpu",
                         seed=7)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    names = {k.split(".")[0] for k in a.state_dict()}
    assert names == {"_PointMLP_0", "_PointMLP_1", "_PointMLP_2",
                     "_PointMLP_3", "head"}
