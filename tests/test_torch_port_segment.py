"""Sorted-segment reductions of the PyTorch port against the JAX package.

The port's CPU path (the plain PyTorch version of the CUDA kernel
``csrc/segment_csr.cu``) is held against ``deepviewagg_tpu.ops.segment``
(XLA scatter) and against the TPU kernel ``segment_*_pallas`` run in
interpret mode.  Max is bit-exact; sums, means and softmaxes agree to 1e-6
relative (only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.ops import pallas_segment as ps
from deepviewagg_tpu.ops import segment as jseg
from deepviewagg_tpu_torch.ops import segment as tseg
from torch_port_util import _torch_threads, rel_err  # noqa: F401
from torch_port_util import segment_case as _case


@pytest.fixture(autouse=True)
def _interpret():
    old = ps.INTERPRET
    ps.INTERPRET = True
    yield
    ps.INTERPRET = old


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_ptr", [False, True])
@pytest.mark.parametrize("one_d", [False, True])
def test_segment_reduce_matches_xla(reduce, with_valid, with_ptr, one_d):
    x, ids, valid, ptr, s = _case(1, one_d=one_d, empty_tail=True)
    # mask some rows inside live segments too, so ``valid`` matters
    rng = np.random.default_rng(2)
    valid = valid & (rng.random(len(valid)) > 0.1)
    v = valid if with_valid else None
    p = ptr if with_ptr else None
    ref = np.asarray(jseg.segment_reduce(
        jnp.asarray(x), jnp.asarray(ids), s, reduce,
        valid=None if v is None else jnp.asarray(v),
        ptr=None if p is None else jnp.asarray(p)))
    got = tseg.segment_reduce(
        _t(x), _t(ids), s, reduce, valid=None if v is None else _t(v),
        ptr=None if p is None else _t(p)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if reduce in ("max", "min"):
        np.testing.assert_array_equal(got, ref)
    else:
        assert rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_csr_plain_matches_pallas_kernel(reduce, with_valid):
    x, ids, valid, ptr, s = _case(3, e=1300, s=200, c=32, empty_tail=True)
    v = valid if with_valid else None
    pfn = ps.segment_sum_pallas if reduce == "sum" else ps.segment_max_pallas
    ref = np.asarray(pfn(jnp.asarray(x), jnp.asarray(ids), s,
                         None if v is None else jnp.asarray(v),
                         jnp.asarray(ptr)))
    got = tseg.segment_csr_plain(
        _t(x), _t(ptr), None if v is None else _t(v), reduce).numpy()
    if reduce == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        assert rel_err(got, ref) <= 1e-6


def test_empty_and_all_masked_segments_are_zero():
    x, ids, valid, ptr, s = _case(4, empty_tail=True)
    for reduce in ("sum", "max"):
        out = tseg.segment_csr(_t(x), _t(ptr), _t(valid), reduce).numpy()
        live = np.zeros(s, bool)
        live[ids[valid]] = True
        assert (~live[:s - 1]).sum() > s // 2
        assert ((np.diff(ptr) > 0) & ~live).any()    # all-masked, not empty
        assert np.abs(out[~live]).max() == 0.0
        assert np.abs(out[s - 1]).max() == 0.0       # the drop segment
    # a max over strictly negative rows stays negative (not clipped at 0)
    neg = -np.abs(x) - 1.0
    out = tseg.segment_csr(_t(neg), _t(ptr), _t(valid), "max").numpy()
    live = np.zeros(s, bool)
    live[ids[valid]] = True
    assert (out[live] < 0).all()


def test_segment_count_ptr_is_pointer_difference():
    _, ids, valid, ptr, s = _case(5)
    got = tseg.segment_count(_t(ids), s, ptr=_t(ptr)).numpy()
    np.testing.assert_array_equal(got, np.diff(ptr).astype(np.float32))
    ref = np.asarray(jseg.segment_count(jnp.asarray(ids), s,
                                        jnp.asarray(valid)))
    got = tseg.segment_count(_t(ids), s, _t(valid)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("with_ptr", [False, True])
def test_segment_softmax_and_weighted_sum_match_xla(scaling, with_ptr):
    x, ids, valid, ptr, s = _case(6, c=4)
    p = ptr if with_ptr else None
    ref = np.asarray(jseg.segment_softmax(
        jnp.asarray(x), jnp.asarray(ids), s, valid=jnp.asarray(valid),
        scaling=scaling, ptr=None if p is None else jnp.asarray(p)))
    got = tseg.segment_softmax(_t(x), _t(ids), s, valid=_t(valid),
                               scaling=scaling,
                               ptr=None if p is None else _t(p)).numpy()
    assert rel_err(got, ref) <= 1e-6
    vals = np.random.default_rng(7).normal(size=(len(ids), 12)).astype(np.float32)
    w = np.repeat(ref, 3, axis=1)
    ref_ws = np.asarray(jseg.segment_weighted_sum(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(ids), s,
        jnp.asarray(valid)))
    got_ws = tseg.segment_weighted_sum(_t(vals), _t(w), _t(ids), s,
                                       _t(valid)).numpy()
    assert rel_err(got_ws, ref_ws) <= 1e-6


def test_gather_segments_and_segment_ptr():
    _, ids, _, ptr, s = _case(8)
    np.testing.assert_array_equal(
        tseg.segment_ptr(_t(ids), s).numpy(), ptr)
    y = np.arange(s * 3, dtype=np.float32).reshape(s, 3)
    np.testing.assert_array_equal(
        tseg.gather_segments(_t(y), _t(ids)).numpy(),
        np.asarray(jseg.gather_segments(jnp.asarray(y), jnp.asarray(ids))))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 2)
    ptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError):
        tseg.segment_csr(x, ptr, None, "mean")
    # a tensor on a device that is neither the CPU nor a card
    with pytest.raises(RuntimeError, match="unsupported device"):
        tseg.segment_csr(x.to("meta"), ptr.to("meta"), None, "sum")


def test_cpu_tensors_never_launch_the_kernel():
    x, ids, valid, ptr, s = _case(9)
    before = dict(tseg.LAUNCHES)
    tseg.segment_max(_t(x), _t(ids), s, _t(valid), _t(ptr))
    assert tseg.LAUNCHES == before
