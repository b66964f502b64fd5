"""Gradients of the port's sorted-segment reductions against the JAX package.

The port's CPU path (``segment_csr_bwd_plain``, the plain version of the CUDA
kernel ``csrc/segment_csr_bwd.cu``) is held against ``jax.grad`` of
``deepviewagg_tpu.ops.segment`` (XLA) and of the TPU kernel's custom VJPs
(``segment_sum_pallas`` / ``segment_max_pallas`` in interpret mode).  Sum,
max and min gradients are copies and selects of the cotangent: bit-equal.
Mean, softmax and weighted-sum gradients agree to 1e-6 relative (summation
order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.ops import pallas_segment as ps
from deepviewagg_tpu.ops import segment as jseg
from deepviewagg_tpu_torch.ops import segment as tseg
from torch_port_util import (_torch_threads, backward_node_names,  # noqa: F401
                             rel_err, segment_case)


@pytest.fixture(autouse=True)
def _interpret():
    old = ps.INTERPRET
    ps.INTERPRET = True
    yield
    ps.INTERPRET = old


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _cot(shape, seed=11):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch_grad(fn, x, cot):
    xt = _t(x, grad=True)
    out = fn(xt)
    out.backward(_t(cot))
    return out.detach().numpy(), xt.grad.numpy()


def _jax_grad(fn, x, cot):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * cot))(jnp.asarray(x)))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_ptr", [False, True])
def test_segment_reduce_grad_matches_xla(reduce, with_valid, with_ptr):
    x, ids, valid, ptr, s = segment_case(1, empty_tail=True)
    valid = valid & (np.random.default_rng(2).random(len(valid)) > 0.1)
    v = valid if with_valid else None
    p = ptr if with_ptr else None
    cot = _cot((s, x.shape[1]))
    ref = _jax_grad(lambda a: jseg.segment_reduce(
        a, jnp.asarray(ids), s, reduce,
        valid=None if v is None else jnp.asarray(v),
        ptr=None if p is None else jnp.asarray(p)), x, cot)
    _, got = _torch_grad(lambda a: tseg.segment_reduce(
        a, _t(ids), s, reduce, valid=None if v is None else _t(v),
        ptr=None if p is None else _t(p)), x, cot)
    if reduce == "mean":
        assert rel_err(got, ref) <= 1e-6
    else:
        np.testing.assert_array_equal(got, ref)
    if v is not None:
        assert np.abs(got[~v]).max() == 0.0      # masked rows get nothing


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_csr_grad_matches_pallas_vjp(reduce, with_valid):
    x, ids, valid, ptr, s = segment_case(3, e=1300, s=200, c=32,
                                         empty_tail=True)
    v = valid if with_valid else None
    cot = _cot((s, 32))
    pfn = ps.segment_sum_pallas if reduce == "sum" else ps.segment_max_pallas
    ref = _jax_grad(lambda a: pfn(
        a, jnp.asarray(ids), s, None if v is None else jnp.asarray(v),
        jnp.asarray(ptr)), x, cot)
    _, got = _torch_grad(lambda a: tseg.segment_csr(
        a, _t(ptr), None if v is None else _t(v), reduce), x, cot)
    np.testing.assert_array_equal(got, ref)


def test_forced_ties_get_the_full_cotangent():
    x, ids, valid, ptr, s = segment_case(4, c=5)
    # duplicate the max row of every segment with at least two valid rows
    tied = []
    for seg in range(s - 1):
        rows = np.flatnonzero((ids == seg) & valid)
        if len(rows) >= 2:
            top = rows[np.argmax(x[rows, 0])]
            other = rows[0] if rows[0] != top else rows[1]
            x[other] = x[rows].max(axis=0)
            x[top] = x[other]
            tied.append((seg, top, other))
    assert len(tied) > 20
    cot = _cot((s, 5))
    _, got = _torch_grad(lambda a: tseg.segment_max(
        a, _t(ids), s, _t(valid), _t(ptr)), x, cot)
    for seg, top, other in tied:
        np.testing.assert_array_equal(got[top], cot[seg])
        np.testing.assert_array_equal(got[other], cot[seg])
    for fn in (lambda a: jseg.segment_max(a, jnp.asarray(ids), s,
                                          jnp.asarray(valid)),
               lambda a: ps.segment_max_pallas(a, jnp.asarray(ids), s,
                                               jnp.asarray(valid),
                                               jnp.asarray(ptr))):
        np.testing.assert_array_equal(got, _jax_grad(fn, x, cot))


def test_empty_and_all_masked_segments_pass_no_gradient():
    x, ids, valid, ptr, s = segment_case(5, empty_tail=True)
    live = np.zeros(s, bool)
    live[ids[valid]] = True
    assert ((np.diff(ptr) > 0) & ~live).any()        # all-masked, not empty
    cot = np.ones((s, x.shape[1]), np.float32)
    for reduce in ("sum", "max"):
        _, got = _torch_grad(lambda a: tseg.segment_csr(
            a, _t(ptr), _t(valid), reduce), x, cot)
        assert np.abs(got[~live[ids]]).max() == 0.0
        assert np.abs(got[~valid]).max() == 0.0
        assert np.isfinite(got).all()
    # rows of live segments: sum passes to all valid rows, max to one per
    # (segment, channel)
    _, gsum = _torch_grad(lambda a: tseg.segment_csr(
        a, _t(ptr), _t(valid), "sum"), x, cot)
    np.testing.assert_array_equal(gsum[valid], 1.0)
    _, gmax = _torch_grad(lambda a: tseg.segment_csr(
        a, _t(ptr), _t(valid), "max"), x, cot)
    assert gmax.sum() == live.sum() * x.shape[1]
    # rows past ptr[-1] and before ptr[0] are outside every segment
    cut = ptr.copy()[3:-2]
    _, gcut = _torch_grad(lambda a: tseg.segment_csr(
        a, _t(cut), None, "sum"), x, np.ones((len(cut) - 1, x.shape[1]),
                                              np.float32))
    assert np.abs(gcut[:cut[0]]).max(initial=0.0) == 0.0
    assert np.abs(gcut[cut[-1]:]).max(initial=0.0) == 0.0
    np.testing.assert_array_equal(gcut[cut[0]:cut[-1]], 1.0)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("with_ptr", [False, True])
def test_segment_softmax_grad_matches_xla(scaling, with_ptr):
    x, ids, valid, ptr, s = segment_case(6, c=4)
    p = ptr if with_ptr else None
    cot = _cot(x.shape)
    ref = _jax_grad(lambda a: jseg.segment_softmax(
        a, jnp.asarray(ids), s, valid=jnp.asarray(valid), scaling=scaling,
        ptr=None if p is None else jnp.asarray(p)), x, cot)
    _, got = _torch_grad(lambda a: tseg.segment_softmax(
        a, _t(ids), s, valid=_t(valid), scaling=scaling,
        ptr=None if p is None else _t(p)), x, cot)
    assert rel_err(got, ref) <= 1e-6


def test_segment_softmax_does_not_differentiate_its_max_shift():
    x, ids, valid, ptr, s = segment_case(7, c=4)
    out = tseg.segment_softmax(_t(x, grad=True), _t(ids), s, valid=_t(valid),
                               ptr=_t(ptr))
    nodes = [n for n in backward_node_names(out) if "SegmentCSR" in n]
    # one segment reduction in the backward graph: the sum of exponentials
    assert len(nodes) == 1, nodes


def test_segment_weighted_sum_grads_match_xla():
    x, ids, valid, ptr, s = segment_case(8, c=12)
    w = np.random.default_rng(9).random((len(ids), 12)).astype(np.float32)
    cot = _cot((s, 12))
    jargs = (jnp.asarray(ids), s, jnp.asarray(valid), jnp.asarray(ptr))
    ref_x, ref_w = jax.grad(
        lambda a, b: jnp.sum(jseg.segment_weighted_sum(a, b, *jargs) * cot),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    tseg.segment_weighted_sum(xt, wt, _t(ids), s, _t(valid),
                              _t(ptr)).backward(_t(cot))
    assert rel_err(xt.grad.numpy(), np.asarray(ref_x)) <= 1e-6
    assert rel_err(wt.grad.numpy(), np.asarray(ref_w)) <= 1e-6


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_bwd_plain_is_the_autograd_of_the_plain_forward(reduce):
    """The plain backward against PyTorch's own differentiation of the plain
    forward, on data without ties (where the conventions coincide)."""
    x, ids, valid, ptr, s = segment_case(10, empty_tail=True)
    cot = _cot((s, x.shape[1]))
    xt = _t(x, grad=True)
    out = tseg.segment_csr_plain(xt, _t(ptr), _t(valid), reduce)
    out.backward(_t(cot))
    got = tseg.segment_csr_bwd_plain(_t(cot), _t(x), out.detach(), _t(ptr),
                                     _t(valid), reduce)
    np.testing.assert_array_equal(got.numpy(), xt.grad.numpy())
