"""Helpers of the point-backbone parity tests (``test_torch_port_kpconv.py``,
``_graph_backbones.py``, ``_randlanet.py``, ``_pointnet.py``,
``_pvcnn.py``): one layer or one model of each package on the same numpy
inputs from the same converted flax variables, in training mode (outputs,
loss, gradients, running statistics after the pass) and in eval mode."""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepviewagg_tpu.nn import pointnet2 as jpn
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import flat_leaves, jax_variables, rel_err


def f32_operands(monkeypatch, jax_modules=(), torch_modules=()):
    """Run the bf16 products of both packages' modules in float32: the JAX
    modules see a ``jnp`` whose ``bfloat16`` is ``float32``, the port's
    ``_bf16_rounded`` becomes the identity.  The two then differ in
    summation order only."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    for mod in jax_modules:
        monkeypatch.setattr(mod, "jnp", proxy)
    for mod in torch_modules:
        monkeypatch.setattr(mod, "_bf16_rounded", lambda t: t)


def assert_same_tree(tmodel, jmodel, *args, **kwargs) -> None:
    """The port model's parameters and running statistics, in flax layout
    under flax paths, have the shapes of the JAX model's tree leaf for
    leaf."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    want = {k: tuple(v.shape) for k, v in flat_leaves(shapes).items()}
    got = {}
    for what in ("params", "batch_stats"):
        got.update({f"{what}/{k}": v.shape for k, v in flat_leaves(
            to_flax_tree(tmodel, what)).items()})
    assert got == want


def leaf_errs(got, want) -> dict:
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    return {k: rel_err(got[k], want[k]) for k in want}


def _maybe_jit(fn, jit: bool):
    """``jax.jit(fn)``, or ``fn`` op by op: under jit XLA may keep a bf16
    product's result in float32 (its excess-precision default), so a module
    whose casts to bf16 are compared runs op by op, where every cast
    rounds as written."""
    return jax.jit(fn) if jit else fn


def layer_runs(jmod, tmod, args, cot, train: bool = True,
               has_train: bool = True, seed: int = 1, jit: bool = True):
    """``jmod`` / ``tmod`` on ``args`` (numpy; the first one differentiated):
    ``(got, want)`` dicts of ``out``, ``gx`` (the first argument's
    gradient of ``sum(out * cot)``), ``grads`` and ``stats`` (flax layout);
    ``jit``: see :func:`_maybe_jit`."""
    kw = {"train": train} if has_train else {}
    variables = jax_variables(jmod, *args, seed=seed,
                              **({"train": False} if has_train else {}))

    def loss(params, x):
        out, new = jmod.apply(dict(variables, params=params), x, *args[1:],
                              mutable=["batch_stats"], **kw)
        return jnp.sum(out * cot), (out, new)

    (_, (j_out, j_new)), (j_gp, j_gx) = _maybe_jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), jit)(variables["params"],
                                                   args[0])
    load_flax_variables(tmod, variables)
    tmod.train(train)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    tx = targs[0].requires_grad_()
    out = tmod(tx, *targs[1:])
    (out * torch.from_numpy(cot)).sum().backward()
    got = {"out": out.detach().numpy(), "gx": tx.grad.numpy(),
           "grads": to_flax_tree(tmod, "grads"),
           "stats": to_flax_tree(tmod, "batch_stats")}
    want = {"out": np.asarray(j_out), "gx": np.asarray(j_gx),
            "grads": jax.device_get(j_gp),
            "stats": jax.device_get(dict(j_new).get("batch_stats", {}))}
    return got, want


def assert_layer_close(got, want, rtol) -> None:
    for key in ("out", "gx"):
        assert rel_err(got[key], want[key]) <= rtol, (key, rel_err(
            got[key], want[key]))
    for key in ("grads", "stats"):
        errs = leaf_errs(got[key], want[key])
        assert not errs or max(errs.values()) <= rtol, (key, errs)


def assert_bf16_layer_close(got, want, rtol, grad_rtol) -> None:
    """A layer with bf16 operands: outputs and running statistics within
    ``rtol``; the input's and the parameters' gradients, where a
    summation-order difference can flip the bf16 rounding of a cotangent by
    one step (2^-8 of it), within ``grad_rtol``."""
    assert rel_err(got["out"], want["out"]) <= rtol
    assert rel_err(got["gx"], want["gx"]) <= grad_rtol
    for key, bound in (("grads", grad_rtol), ("stats", rtol)):
        errs = leaf_errs(got[key], want[key])
        assert not errs or max(errs.values()) <= bound, (key, errs)


def masked_ce_jax(logits, labels, valid):
    lp = jax.nn.log_softmax(logits)
    ll = jnp.take_along_axis(lp, labels[:, None], 1)[:, 0]
    return -jnp.sum(jnp.where(valid, ll, 0.0)) / valid.sum()


def masked_ce_torch(logits, labels, valid):
    lp = torch.log_softmax(logits, -1)
    ll = torch.gather(lp, 1, torch.from_numpy(labels).long()[:, None])[:, 0]
    v = torch.from_numpy(valid)
    return -torch.sum(torch.where(v, ll, 0.0)) / v.sum()


def model_runs(jmodel, tmodel, batch, labels, loss_valid, seed: int = 2,
               variables=None, jit: bool = True):
    """Both models on ``batch`` (numpy): eval-mode logits first, then in
    training mode the logits, the masked CE loss over ``loss_valid`` rows,
    its gradients and the running statistics after the pass, and the
    global gradient norm: ``(got, want)``; ``jit``: see
    :func:`_maybe_jit`."""
    if variables is None:
        variables = jax_variables(jmodel, batch, train=False, seed=seed)

    def loss(params):
        out, new = jmodel.apply(dict(variables, params=params), batch,
                                train=True, mutable=["batch_stats"])
        return masked_ce_jax(out["logits"], labels, loss_valid), (out, new)

    (j_loss, (j_out, j_new)), j_grads = _maybe_jit(jax.value_and_grad(
        loss, has_aux=True), jit)(variables["params"])
    j_eval = _maybe_jit(lambda v: jmodel.apply(v, batch, train=False)[
        "logits"], jit)(variables)

    load_flax_variables(tmodel, variables)
    tb = batch_to_torch(batch, "cpu")
    # eval first: the train-mode pass updates the running statistics
    tmodel.eval()
    with torch.no_grad():
        t_eval = tmodel(tb)["logits"].numpy()
    tmodel.train()
    logits = tmodel(tb)["logits"]
    t_loss = masked_ce_torch(logits, labels, loss_valid)
    t_loss.backward()
    t_norm = float(torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                                  for p in tmodel.parameters())))
    j_norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g
                               in jax.tree_util.tree_leaves(j_grads))))
    got = {"loss": float(t_loss.detach()), "logits": logits.detach().numpy(),
           "grads": to_flax_tree(tmodel, "grads"),
           "stats": to_flax_tree(tmodel, "batch_stats"), "eval": t_eval,
           "grad_norm": t_norm}
    want = {"loss": float(j_loss), "logits": np.asarray(j_out["logits"]),
            "grads": jax.device_get(j_grads),
            "stats": jax.device_get(j_new["batch_stats"]),
            "eval": np.asarray(j_eval), "grad_norm": j_norm}
    return got, want


def assert_model_close(got, want, rows, rtol) -> None:
    """Logits (train and eval mode, over ``rows``), loss, every gradient
    leaf and every running statistic within ``rtol``."""
    for key in ("logits", "eval"):
        err = rel_err(got[key][rows], want[key][rows])
        assert err <= rtol, (key, err)
    assert abs(got["loss"] - want["loss"]) <= rtol * abs(want["loss"])
    for key in ("grads", "stats"):
        errs = leaf_errs(got[key], want[key])
        assert max(errs.values()) <= rtol, (key, errs)


@functools.lru_cache(maxsize=None)
def graph_batch(n=900, n_points=(160, 40), radii=(0.4, 0.8), k=12,
                self_k=0, in_channels=4, classes=5, seed=3):
    """A one-sample pointnet graph built by the JAX package (both models
    read the same tables) with features, a validity mask (the last 50 rows
    padding) and labels.  Cached: do not write into it."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-50:] = False
    graph = jpn.build_pointnet_graph(pos, np.zeros(n, np.int32), valid,
                                     n_points=n_points, radii=radii, k=k,
                                     self_k=self_k)
    batch = {"pn_graph": graph,
             "feats": rng.normal(size=(n, in_channels)).astype(np.float32),
             "valid": valid}
    return batch, rng.integers(0, classes, n).astype(np.int32)


def neighbourhood(m=200, k=10, p=300, c=6, seed=0):
    """Layer inputs over a neighbourhood table: ``(feats [P, C], rel [M, k,
    3], idx int32 [M, k], count int32 [M], valid [M])``; some centres
    invalid, some of those with a count of 0."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(p, c)).astype(np.float32)
    rel = rng.uniform(-0.3, 0.3, (m, k, 3)).astype(np.float32)
    idx = rng.integers(0, p, (m, k)).astype(np.int32)
    valid = rng.uniform(size=m) > 0.15
    # a valid centre holds at least itself (a ball query's first hit); an
    # invalid one may hold nothing
    count = rng.integers(0, k + 1, m).astype(np.int32)
    count = np.where(valid, np.maximum(count, 1), count).astype(np.int32)
    return feats, rel, idx, count, valid
