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


# --- the tiled scheme of the CUDA kernel, in plain PyTorch ------------------

EDGE_WIDTHS = (1, 3, 4, 5, 32, 64, 128, 130)
EDGE_CASES = [name for name, *_ in tseg.segment_edge_cases(32, 1)]


def test_edge_cases_cover_the_tile_edges():
    """The generator really holds what its names say, at any tile size."""
    for tile in (32, 96, 1024):
        cases = {n: (x, p.numpy(), v) for n, x, p, v
                 in tseg.segment_edge_cases(tile, 4)}
        assert list(cases) == EDGE_CASES
        assert np.diff(cases["long"][1]).max() > 3 * tile
        edges = cases["on_edges"][1]
        assert tile in edges and 2 * tile in edges and 4 * tile in edges
        p = cases["empty_at_edge"][1]
        assert (np.diff(p)[p[:-1] == tile] == 0).sum() >= 3
        assert (p[:-1] == p[-1]).sum() >= 2       # empty, behind the last row
        _, p, v = cases["dead_tile"]
        assert not v[tile:2 * tile].any() and v[:tile].all()
        _, p, v = cases["drop_in_middle"]
        assert p[21] - p[20] > 3 * tile and not v[p[20]:p[21]].any()
        assert v[:p[20]].any() and v[p[21]:].any()
        x, p, _ = cases["offset"]
        assert p[0] > tile and p[-1] < x.shape[0]
        assert cases["under_one_tile"][0].shape[0] < tile
        assert len(cases["one_segment"][1]) == 2
        assert cases["long_unmasked"][2] is None
        assert cases["no_rows"][0].shape[0] == 0
        x, p, v = cases["all_empty_all_masked"]
        assert (np.diff(p) == 0).sum() > 2 * tile and p[-2] == 0
        assert p[-1] == x.shape[0] and not v.any()
        _, p, v = cases["empties_between_live"]
        n = np.diff(p)
        assert (n == 0).sum() > 100 and (n > 0).sum() > 60 and n.max() > tile
        assert not v[p[-2]:].any() and not v[:p[1]].any() and v.any()


@pytest.mark.parametrize("tile", [32, 96, 1024])
@pytest.mark.parametrize("channels", EDGE_WIDTHS)
def test_tiled_plain_matches_plain_on_edge_cases(tile, channels):
    for name, x, ptr, valid in tseg.segment_edge_cases(tile, channels):
        for reduce in ("sum", "max"):
            ref = tseg.segment_csr_plain(x, ptr, valid, reduce)
            got = tseg.segment_csr_tiled_plain(x, ptr, valid, reduce, tile)
            assert got.shape == ref.shape, name
            if reduce == "max":
                assert torch.equal(got, ref), (name, reduce)
            elif ref.numel():
                assert rel_err(got.numpy(), ref.numpy()) <= 1e-6, name


@pytest.mark.parametrize("tile", [32, 96, 1024])
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_tiled_plain_matches_plain_on_random_rows(tile, reduce):
    """Values that do round: the tiled order of addition stays within 1e-6."""
    x, ids, valid, ptr, s = _case(11, e=3000, s=300, c=8, empty_tail=True)
    ref = tseg.segment_csr_plain(_t(x), _t(ptr), _t(valid), reduce)
    got = tseg.segment_csr_tiled_plain(_t(x), _t(ptr), _t(valid), reduce, tile)
    if reduce == "max":
        assert torch.equal(got, ref)
    else:
        assert rel_err(got.numpy(), ref.numpy()) <= 1e-6


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("channels", [1, 4, 130])
def test_plain_matches_jax_on_edge_cases(case, channels):
    """``segment_csr_plain`` against the JAX package on the tile-edge inputs
    (XLA path; the rows outside ``[ptr[0], ptr[S])`` are cut off first, since
    ids cannot express them)."""
    name, x, ptr, valid = next(
        c for c in tseg.segment_edge_cases(96, channels) if c[0] == case)
    p = ptr.numpy()
    s = len(p) - 1
    lo, hi = int(p[0]), int(p[-1])
    ids = np.repeat(np.arange(s), np.diff(p)).astype(np.int32)
    xs = x.numpy()[lo:hi]
    v = None if valid is None else valid.numpy()[lo:hi]
    for reduce, jfn in (("sum", jseg.segment_sum), ("max", jseg.segment_max)):
        got = tseg.segment_csr_plain(x, ptr, valid, reduce).numpy()
        if hi == lo:
            assert got.shape == (s, channels) and not got.any()
            continue
        ref = np.asarray(jfn(jnp.asarray(xs), jnp.asarray(ids), s,
                             None if v is None else jnp.asarray(v)))
        if reduce == "max":
            np.testing.assert_array_equal(got, ref)
        else:
            assert rel_err(got, ref) <= 1e-6


def test_kernel_tile_rows_is_one_the_kernel_takes():
    for c in (1, 2, 4, 8, 16, 32, 64, 128, 130, 512):
        tile = tseg.kernel_tile_rows(c)
        assert 32 <= tile <= 2048 and tile % 32 == 0


def test_segment_softmax_takes_the_callers_max_and_count():
    x, ids, valid, ptr, s = _case(12, c=4)
    args = (_t(x), _t(ids), s)
    for scaling in (False, True):
        ref = tseg.segment_softmax(*args, valid=_t(valid), scaling=scaling,
                                   ptr=_t(ptr))
        cmax = tseg.segment_max(*args, _t(valid), _t(ptr))
        count = tseg.segment_count(_t(ids), s, _t(valid), _t(ptr))
        got = tseg.segment_softmax(*args, valid=_t(valid), scaling=scaling,
                                   ptr=_t(ptr), seg_max=cmax, count=count)
        assert torch.equal(got, ref)
