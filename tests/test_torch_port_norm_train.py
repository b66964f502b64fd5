"""``MaskedBatchNorm`` in training mode against the JAX package: output,
gradients and running statistics after two steps, with and without a mask,
plus the momentum override and the all-invalid mask.  Both sides compute
masked float32 sums and differ in summation order only (1e-7 per sum), but
``var = E[x^2] - mean^2`` cancels: on the second input (mean -2, std 0.5) it
amplifies that difference by ``E[x^2] / var = 17``.  So outputs and running
statistics are held to 1e-5 relative and gradients, which sum the
normalized values once more, to 5e-5."""

_TOL, _GRAD_TOL = 1e-5, 5e-5

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import norm as jnorm
from deepviewagg_tpu_torch.nn import norm as tnorm
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, jax_variables,  # noqa: F401
                             rel_err)


def _inputs(n=300, c=24):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(n, c)) * 3.0 + 1.0).astype(np.float32)
    x2 = (rng.normal(size=(n, c)) * 0.5 - 2.0).astype(np.float32)
    valid = rng.random(n) > 0.3
    cot = rng.normal(size=(n, c)).astype(np.float32)
    return x, x2, valid, cot


def _pair(x, valid):
    jbn = jnorm.MaskedBatchNorm()
    variables = jax_variables(jbn, x, valid, seed=5, train=False)
    tbn = tnorm.MaskedBatchNorm(x.shape[1]).train()
    load_flax_variables(tbn, variables)
    return jbn, variables, tbn


@pytest.mark.parametrize("with_valid", [True, False])
def test_train_output_grads_and_running_stats_match_jax(with_valid):
    x, x2, valid, cot = _inputs()
    v = valid if with_valid else None
    jbn, variables, tbn = _pair(x, v)
    tv = None if v is None else torch.from_numpy(v)

    def loss(params, stats, inp):
        y, upd = jbn.apply({"params": params, "batch_stats": stats}, inp, v,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    stats = variables["batch_stats"]
    for step, inp in enumerate((x, x2)):
        (_, (ref_y, stats)), (ref_gp, ref_gx) = jax.value_and_grad(
            lambda p, a: loss(p, stats, a), argnums=(0, 1), has_aux=True)(
                variables["params"], jnp.asarray(inp))
        xt = torch.from_numpy(inp).requires_grad_()
        tbn.zero_grad()
        y = tbn(xt, tv)
        y.backward(torch.from_numpy(cot))
        assert rel_err(y.detach().numpy(), np.asarray(ref_y)) <= _TOL
        assert rel_err(xt.grad.numpy(), np.asarray(ref_gx)) <= _GRAD_TOL
        got_gp = to_flax_tree(tbn, "grads")
        for k in ("scale", "bias"):
            assert rel_err(got_gp[k], np.asarray(ref_gp[k])) <= _GRAD_TOL, k
        got_stats = to_flax_tree(tbn, "batch_stats")
        for k in ("mean", "var"):
            assert rel_err(got_stats[k], np.asarray(stats[k])) <= _TOL, (step, k)


def test_running_variance_is_biased():
    x, _, valid, _ = _inputs()
    tbn = tnorm.MaskedBatchNorm(x.shape[1]).train()
    tbn(torch.from_numpy(x), torch.from_numpy(valid))
    xv = x[valid].astype(np.float64)
    want = 0.9 * 1.0 + 0.1 * xv.var(axis=0)            # ddof = 0
    assert rel_err(tbn.running_var.numpy(), want) <= 1e-5
    unbiased = 0.9 * 1.0 + 0.1 * xv.var(axis=0, ddof=1)
    assert rel_err(tbn.running_var.numpy(), unbiased) > 1e-4


def test_all_invalid_mask_gives_no_nan():
    x, _, valid, cot = _inputs()
    none = np.zeros_like(valid)
    jbn, variables, tbn = _pair(x, none)
    ref, upd = jbn.apply(variables, x, none, train=True,
                         mutable=["batch_stats"])
    xt = torch.from_numpy(x).requires_grad_()
    y = tbn(xt, torch.from_numpy(none))
    y.backward(torch.from_numpy(cot))
    assert torch.isfinite(y).all() and torch.isfinite(xt.grad).all()
    assert torch.isfinite(tbn.running_mean).all()
    assert torch.isfinite(tbn.running_var).all()
    assert rel_err(y.detach().numpy(), np.asarray(ref)) <= _TOL
    got = to_flax_tree(tbn, "batch_stats")
    for k in ("mean", "var"):
        assert rel_err(got[k], np.asarray(upd["batch_stats"][k])) <= _TOL


def test_bn_momentum_override_matches_jax():
    x, _, valid, _ = _inputs()
    jbn, variables, tbn = _pair(x, valid)
    with jnorm.bn_momentum(0.5):
        _, upd = jbn.apply(variables, x, valid, train=True,
                           mutable=["batch_stats"])
    with tnorm.bn_momentum(0.5):
        tbn(torch.from_numpy(x), torch.from_numpy(valid))
    got = to_flax_tree(tbn, "batch_stats")
    for k in ("mean", "var"):
        assert rel_err(got[k], np.asarray(upd["batch_stats"][k])) <= _TOL
    # outside the context the module's own momentum is back
    before = tbn.running_mean.clone()
    tbn(torch.from_numpy(x), torch.from_numpy(valid))
    xm = torch.from_numpy(x[valid]).mean(0)
    assert rel_err((tbn.running_mean - 0.9 * before).numpy(),
                   (0.1 * xm).numpy()) <= 1e-4


def test_eval_mode_leaves_running_stats_alone():
    x, _, valid, _ = _inputs()
    _, _, tbn = _pair(x, valid)
    tbn.eval()
    before = (tbn.running_mean.clone(), tbn.running_var.clone())
    tbn(torch.from_numpy(x), torch.from_numpy(valid))
    assert torch.equal(tbn.running_mean, before[0])
    assert torch.equal(tbn.running_var, before[1])
