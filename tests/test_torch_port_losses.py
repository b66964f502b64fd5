"""The port's losses against the JAX package: values and logit gradients of
the masked cross-entropy (class weights, ignore labels, validity), the
Lovász-softmax (with an absent class and with every class present) and the
view-level loss.  Same float32
arithmetic, summation order only: 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.models import losses as jl
from deepviewagg_tpu_torch.models import losses as tl
from deepviewagg_tpu_torch.ops import lovasz as lv
from torch_port_util import _torch_threads, rel_err  # noqa: F401

_TOL = 1e-6


def _case(n=400, c=6, seed=0, absent=True):
    """``absent``: class ``c - 1`` is in no label."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, c)) * 2.0).astype(np.float32)
    labels = rng.integers(0, c - 1 if absent else c, n).astype(np.int32)
    labels[rng.random(n) < 0.1] = -1
    valid = rng.random(n) > 0.2
    weights = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return logits, labels, valid, weights


def _both(jfn, tfn, logits):
    ref, ref_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tfn(lt)
    got.backward()
    return float(got.detach()), lt.grad.numpy(), float(ref), np.asarray(ref_g)


def _check(jfn, tfn, logits):
    got, got_g, ref, ref_g = _both(jfn, tfn, logits)
    assert abs(got - ref) <= _TOL * max(abs(ref), 1.0), (got, ref)
    assert rel_err(got_g, ref_g) <= _TOL
    return got, got_g


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_weights", [False, True])
def test_cross_entropy_matches_jax(with_valid, with_weights):
    logits, labels, valid, weights = _case()
    v = valid if with_valid else None
    w = weights if with_weights else None
    _, grad = _check(
        lambda a: jl.cross_entropy(a, jnp.asarray(labels),
                                   None if v is None else jnp.asarray(v), w),
        lambda a: tl.cross_entropy(a, torch.from_numpy(labels),
                                   None if v is None else torch.from_numpy(v),
                                   w),
        logits)
    dead = labels == -1
    if v is not None:
        dead |= ~v
    assert np.abs(grad[dead]).max() == 0.0


def test_cross_entropy_with_nothing_to_score_is_zero():
    logits, labels, _, _ = _case()
    nothing = np.zeros(len(labels), bool)
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(nothing))
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(nothing))
    assert float(got) == float(ref) == 0.0


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("absent", [True, False],
                         ids=["an_absent_class", "every_class_present"])
def test_lovasz_softmax_matches_jax(absent, with_valid):
    """The class-major loss (sorted ``[C, N]`` rows, the scan's plain
    version on the CPU) against the JAX package, with one class absent from
    the labels and with every class present."""
    logits, labels, valid, _ = _case(seed=1, absent=absent)
    assert (labels == logits.shape[1] - 1).any() != absent
    v = valid if with_valid else None
    _check(
        lambda a: jl.lovasz_softmax(a, jnp.asarray(labels),
                                    None if v is None else jnp.asarray(v)),
        lambda a: tl.lovasz_softmax(a, torch.from_numpy(labels),
                                    None if v is None else torch.from_numpy(v)),
        logits)


def test_lovasz_grad_matches_jax():
    fg = (np.random.default_rng(2).random(50) > 0.6).astype(np.float32)
    ref = np.asarray(jl._lovasz_grad(jnp.asarray(fg)))
    got = lv.lovasz_grad(torch.from_numpy(fg)[:, None])[:, 0].numpy()
    assert rel_err(got, ref) <= _TOL
    empty = np.zeros(5, np.float32)                    # union clamp at 1
    np.testing.assert_allclose(
        lv.lovasz_grad(torch.from_numpy(empty)[:, None])[:, 0].numpy(),
        np.asarray(jl._lovasz_grad(jnp.asarray(empty))), atol=1e-7)


def test_segmentation_loss_matches_jax():
    logits, labels, valid, weights = _case(seed=3)
    _check(
        lambda a: jl.segmentation_loss(a, jnp.asarray(labels),
                                       jnp.asarray(valid), 0.5, weights),
        lambda a: tl.segmentation_loss(a, torch.from_numpy(labels),
                                       torch.from_numpy(valid), 0.5, weights),
        logits)
    # weight 0 is the cross-entropy alone
    a = tl.segmentation_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), torch.from_numpy(valid))
    b = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(valid))
    assert float(a) == float(b)


def test_view_level_loss_matches_jax():
    rng = np.random.default_rng(4)
    _, labels, _, _ = _case(n=120, seed=4)
    nv = 500
    view_logits = rng.normal(size=(nv, 6)).astype(np.float32)
    point_id = np.sort(rng.integers(0, 125, nv)).astype(np.int32)  # > n-1 too
    view_valid = rng.random(nv) > 0.25
    _check(
        lambda a: jl.view_level_loss(a, jnp.asarray(labels),
                                     jnp.asarray(point_id),
                                     jnp.asarray(view_valid)),
        lambda a: tl.view_level_loss(a, torch.from_numpy(labels),
                                     torch.from_numpy(point_id),
                                     torch.from_numpy(view_valid)),
        view_logits)


def test_sqrt_inverse_class_weights_match_jax():
    counts = np.array([1000, 10, 0, 250, 3], np.float32)
    ref = np.asarray(jl.sqrt_inverse_class_weights(counts))
    got = tl.sqrt_inverse_class_weights(counts).numpy()
    assert rel_err(got, ref) <= _TOL
    assert tl.IGNORE_LABEL == jl.IGNORE_LABEL == -1
