"""The training path as a whole: two optimizer steps of the JAX package's
``make_train_step`` and of the port's on the same numpy batch, from the same
converted variables, with SGD + momentum, weight decay and clipping as the
benchmark builds them.  ``TINY_SPEC`` on ``TINY_BATCH``.

With float32 conv operands everywhere (``f32_sparse_convs`` and the towers'
``f32_convs``) the two differ in summation order only: the loss agrees to
1e-5, every gradient leaf to 1e-4 of the leaf's largest magnitude, and
parameters and running statistics after two steps to 1e-4.  With the
production bf16 operands, rounding flips (see ``f32_sparse_convs``) move
single operands by 2^-8, the forward chains drift by 1e-4 .. 2e-3, and each
masked batch norm's backward (a cancellation over the few voxels of this
tiny batch) amplifies that about five times per layer: single gradient
leaves differ by up to tens of percent, just as the bf16 and the float32
gradients of one framework do (13% at the median leaf in either).  So the
bf16 run is held at the loss (2e-3) and the gradient norm (5e-2); the
per-operation bf16 gradients are held to 1e-5 in
``test_torch_port_sparse_grad.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.models.losses import segmentation_loss as jax_seg_loss
from deepviewagg_tpu.models.segmentation import MultimodalSeg as JaxSeg
from deepviewagg_tpu.modules import image_encoders as jax_towers
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
from deepviewagg_tpu_torch.modules import branch as tbranch
from deepviewagg_tpu_torch.modules import image_encoders as torch_towers
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves, jax_tiny_batch,
                             jax_model_variables, rel_err, torch_batch)

_OPT = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=10.0)
_LR = 0.1


def _specs(f32: bool):
    jspec, tspec = jax_flagship_spec(**TINY_SPEC), flagship_spec(**TINY_SPEC)
    if f32:
        jspec = dataclasses.replace(jspec, branches=tuple(
            (lvl, dataclasses.replace(b, tower_bf16=False))
            for lvl, b in jspec.branches))
        tspec = dataclasses.replace(tspec, branches=tuple(
            (lvl, dataclasses.replace(b, tower_bf16=False))
            for lvl, b in tspec.branches))
    return jspec, tspec


def _run_both(f32: bool, steps: int = 2):
    """``steps`` train steps of both packages; the first step's loss and
    gradients, every step's metrics, and the final parameters and running
    statistics, all as flax-layout numpy trees."""
    batch, _ = jax_tiny_batch()
    jspec, tspec = _specs(f32)
    jmodel = JaxSeg(jspec)
    variables = jax_model_variables(jmodel, seed=1)

    # --- the JAX package -------------------------------------------------
    tx = jopt.make_optimizer(jopt.make_schedule("constant", _LR), **_OPT)
    state = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    train_step = jax.jit(jstep.make_train_step(jmodel))

    @jax.jit
    def loss_and_grads(params, stats):
        def loss_fn(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": stats}, batch,
                                  train=True, mutable=["batch_stats"])
            return jax_seg_loss(out["logits"], batch["labels"],
                                batch["graph"]["levels"][0]["valid"])
        return jax.value_and_grad(loss_fn)(params)

    ref = {"metrics": []}
    loss0, grads0 = loss_and_grads(state.params, state.batch_stats)
    ref["loss0"], ref["grads0"] = float(loss0), jax.device_get(grads0)
    for _ in range(steps):
        state, m = train_step(state, batch, jax.random.PRNGKey(0))
        ref["metrics"].append({k: np.asarray(v) for k, v in m.items()})
    ref["params"] = jax.device_get(state.params)
    ref["batch_stats"] = jax.device_get(state.batch_stats)
    ref["step"] = int(state.step)

    # --- the port --------------------------------------------------------
    tmodel = MultimodalSeg(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    tstate = tstep.TrainState.create(tmodel, topt.make_optimizer(
        topt.make_schedule("constant", _LR), **_OPT))
    t_train_step = tstep.make_train_step(tmodel)
    tb = torch_batch(batch)
    got = {"metrics": []}
    for i in range(steps):
        tstate, m = t_train_step(tstate, tb, None)
        got["metrics"].append({k: v.numpy() for k, v in m.items()})
        if i == 0:
            got["loss0"] = float(m["loss"])
            got["grads0"] = to_flax_tree(tmodel, "grads")
    got["params"] = to_flax_tree(tmodel, "params")
    got["batch_stats"] = to_flax_tree(tmodel, "batch_stats")
    got["step"] = tstate.step
    got["training"] = tmodel.training
    return ref, got, variables


@pytest.fixture(scope="module")
def f32_runs():
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jax_towers.f32_convs(), torch_towers.f32_convs():
            return _run_both(f32=True)


def _leaf_errs(got, ref):
    got, ref = flat_leaves(got), flat_leaves(ref)
    assert sorted(got) == sorted(ref)
    return {k: rel_err(got[k], ref[k]) for k in ref}


def test_loss_matches_jax(f32_runs):
    ref, got, _ = f32_runs
    assert abs(got["loss0"] - ref["loss0"]) <= 1e-5 * abs(ref["loss0"])
    for g, r in zip(got["metrics"], ref["metrics"]):
        assert abs(float(g["loss"]) - float(r["loss"])) <= 1e-5 * abs(float(r["loss"]))
    # the loss fell on the repeated batch
    assert float(got["metrics"][1]["loss"]) < float(got["metrics"][0]["loss"])


def test_every_gradient_leaf_matches_jax(f32_runs):
    ref, got, _ = f32_runs
    errs = _leaf_errs(got["grads0"], ref["grads0"])
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    assert not bad, bad
    assert all(np.abs(g).max() > 0 for g in flat_leaves(got["grads0"]).values())


def test_grad_norm_and_preds_match_jax(f32_runs):
    ref, got, _ = f32_runs
    n = int(np.asarray(jax_tiny_batch()[0]["graph"]["levels"][0]["valid"]).sum())
    for g, r in zip(got["metrics"], ref["metrics"]):
        assert abs(float(g["grad_norm"]) - float(r["grad_norm"])) \
            <= 1e-4 * float(r["grad_norm"])
        assert (g["preds"][:n] == r["preds"][:n]).mean() >= 0.999
    # raw norm, before clipping: equal to the norm of the gradient leaves
    raw = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                      for g in flat_leaves(got["grads0"]).values()))
    assert abs(float(got["metrics"][0]["grad_norm"]) - raw) <= 1e-5 * raw


def test_parameters_after_two_steps_match_jax(f32_runs):
    ref, got, variables = f32_runs
    assert got["step"] == ref["step"] == 2 and got["training"]
    errs = _leaf_errs(got["params"], ref["params"])
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    assert not bad, bad
    moved = _leaf_errs(got["params"], variables["params"])
    assert all(e > 0 for e in moved.values())


def test_batch_stats_after_two_steps_match_jax(f32_runs):
    ref, got, variables = f32_runs
    errs = _leaf_errs(got["batch_stats"], ref["batch_stats"])
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    assert not bad, bad
    moved = _leaf_errs(got["batch_stats"], variables["batch_stats"])
    assert all(e > 0 for e in moved.values())


def test_bf16_step_stays_close_to_jax():
    ref, got, _ = _run_both(f32=False, steps=1)
    assert abs(got["loss0"] - ref["loss0"]) <= 2e-3 * abs(ref["loss0"])
    g, r = got["metrics"][0], ref["metrics"][0]
    assert abs(float(g["grad_norm"]) - float(r["grad_norm"])) \
        <= 5e-2 * float(r["grad_norm"])


def test_eval_step_matches_forward_and_keeps_state():
    batch, _ = jax_tiny_batch()
    _, tspec = _specs(f32=False)
    model = MultimodalSeg(tspec, device="cpu", seed=2)
    state = tstep.TrainState.create(model, topt.make_optimizer(
        topt.make_schedule("constant", _LR)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = tstep.make_eval_step(model)(state, torch_batch(batch))
    assert not model.training and set(res) == {"logits", "preds", "x_seen"}
    assert torch.equal(res["preds"], res["logits"].argmax(-1))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- dropout ---------------------------------------------------------------

def test_modality_dropout_identity_without_rate_or_generator():
    x = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    assert tbranch.ModalityDropout(0.0)(x, gen) is x
    assert tbranch.ModalityDropout(0.5)(x, None) is x
    assert tbranch.soft_dropout(x, 0.0, gen) is x
    assert tbranch.soft_dropout(x, 0.5, None) is x


def test_modality_dropout_is_all_or_nothing_and_reproducible():
    x = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    drop = tbranch.ModalityDropout(0.4)

    def draws(seed, n=200):
        gen = torch.Generator().manual_seed(seed)
        return [drop(x, gen) for _ in range(n)]

    outs = draws(3)
    kept = [torch.equal(o, x / 0.6) for o in outs]
    zero = [bool((o == 0).all()) for o in outs]
    assert all(k or z for k, z in zip(kept, zero))
    assert 0.45 <= np.mean(kept) <= 0.75                 # p(keep) = 0.6
    again = draws(3)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    other = draws(4)
    assert any(not torch.equal(a, b) for a, b in zip(outs, other))


def test_soft_dropout_scales_kept_elements():
    x = torch.ones(4000)
    y = tbranch.soft_dropout(x, 0.25, torch.Generator().manual_seed(5))
    assert set(np.unique(y.numpy())) == {0.0, np.float32(1 / 0.75)}
    assert 0.70 <= float((y > 0).float().mean()) <= 0.80


def test_model_dropout_follows_the_generator():
    batch, _ = jax_tiny_batch()
    tb = torch_batch(batch)
    _, tspec = _specs(f32=False)
    dropped = dataclasses.replace(tspec, branches=tuple(
        (lvl, dataclasses.replace(b, drop_modality=0.5))
        for lvl, b in tspec.branches))
    model = MultimodalSeg(dropped, device="cpu", seed=2).train()
    plain = MultimodalSeg(tspec, device="cpu", seed=2).train()
    with torch.no_grad():
        base = plain(tb)["logits"]
        # no generator: every dropout is the identity, in training mode too
        assert torch.equal(model(tb)["logits"], base)
        outs = [model(tb, generator=torch.Generator().manual_seed(s))["logits"]
                for s in range(6)]
        again = model(tb, generator=torch.Generator().manual_seed(0))["logits"]
    assert torch.equal(outs[0], again)
    assert len({float(o.abs().sum()) for o in outs}) == 2   # kept or dropped
