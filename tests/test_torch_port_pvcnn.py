"""The port's PVCNN (``nn/pvcnn.py``) against the JAX package's, on the same
numpy batch of two samples from the same converted flax variables:
``normalize_to_grid``, ``PVConv`` alone and ``PVCNNSeg`` whole.

The voxel mean runs through the sorted-segment reduction in the port (a sum
and a count per block over the stably sorted keys) where the JAX package
takes an unsorted ``segment_sum``; both sum the same rows per cell.  The
convolutions take a bf16-rounded grid against a float32 kernel in both
(flax's ``Conv(dtype=None)`` promotes to float32), and the port rounds at
the same casts, so with float32 operands (``f32_operands``) the two differ
in summation order only: 1e-5 of the largest magnitude for a layer, 1e-4
for the model (ROADMAP C). With bf16 operands a summation-order difference
can flip the bf16 rounding of the grid's cotangent by one step, 2^-8 of it:
the layer's outputs and running statistics stay at 1e-4, its gradients are
held at 1e-2 (3.5e-4 measured on the input's gradient in training mode);
the model stays at 1e-4 throughout (5e-6 measured on its gradient leaves).
Under ``jax.jit`` XLA may keep a rounded grid in float32 (its excess-
precision default), so the bf16 cases run the JAX module op by op.
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import pvcnn as jpv
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.nn import pvcnn as tpv
from deepviewagg_tpu_torch.ops import segment as tseg
from torch_port_backbones import (assert_bf16_layer_close,
                                  assert_layer_close, assert_model_close,
                                  assert_same_tree, f32_operands, layer_runs,
                                  model_runs)
from torch_port_util import _torch_threads  # noqa: F401

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
BF16_GRAD_RTOL = 1e-2
N, B = 1000, 2
RES, BASE = (8, 6), 8
CHANNELS = (8, 16)


def _cloud(seed=4):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 3, (N, 3)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[-40:] = False
    # collate's convention: padding rows carry batch_idx == num_batches
    batch_idx = np.where(valid, np.arange(N) >= N // 2, B).astype(np.int32)
    feats = rng.normal(size=(N, 4)).astype(np.float32)
    return pos, batch_idx, valid, feats, rng.integers(0, 5, N).astype(
        np.int32)


def _batch():
    pos, batch_idx, valid, feats, labels = _cloud()
    gc, _ = jpv.normalize_to_grid(pos, batch_idx, valid, BASE, B)
    batch = {"feats": feats, "valid": valid, "pv_grid_coords": gc,
             "pv_batch_idx": batch_idx, "pv_resolution": BASE}
    for r in RES:
        batch[f"pv_key_r{r}"] = jpv.normalize_to_grid(pos, batch_idx, valid,
                                                      r, B)[1]
    return batch, labels


@pytest.mark.parametrize("resolution", [8, 24])
def test_normalize_to_grid_matches_jax(resolution):
    pos, batch_idx, valid, _, _ = _cloud(resolution)
    want = jpv.normalize_to_grid(pos, batch_idx, valid, resolution, B)
    got = tpv.normalize_to_grid(pos, batch_idx, valid, resolution, B)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # padding rows: the drop cell
    assert (got[1][~valid] == B * resolution**3).all()


@pytest.mark.parametrize("operands", ["bf16", "f32"])
@pytest.mark.parametrize("train", [True, False])
def test_pvconv_layer_matches_jax(operands, train, monkeypatch):
    if operands == "f32":
        f32_operands(monkeypatch, [jpv], [tpv])
    batch, _ = _batch()
    r = RES[0]
    args = (batch["feats"], batch["pv_grid_coords"], batch[f"pv_key_r{r}"],
            batch["pv_batch_idx"], batch["valid"])
    cot = np.random.default_rng(2).normal(size=(N, 8)).astype(np.float32)
    got, want = layer_runs(jpv.PVConv(8, resolution=r, num_batches=B),
                           tpv.PVConv(4, 8, r, B, device="cpu"), args, cot,
                           train=train, jit=operands == "f32")
    if operands == "f32":
        assert_layer_close(got, want, LAYER_RTOL)
    else:
        assert_bf16_layer_close(got, want, MODEL_RTOL, BF16_GRAD_RTOL)


def test_voxel_mean_is_two_segment_sums_a_block(monkeypatch):
    """Each block reduces its sorted rows with ``segment_csr``: one sum of
    the features and one count, over ``B * r^3 + 1`` segments; only the
    sums of blocks 2 and 3 (whose input takes a gradient) run backward."""
    batch, labels = _batch()
    calls, bwd = [], []
    inner, inner_b = tseg.segment_csr_plain, tseg.segment_csr_bwd_plain
    monkeypatch.setattr(tseg, "segment_csr_plain", lambda x, p, v, r: (
        calls.append((x.shape, p.numel() - 1, r)) or inner(x, p, v, r)))
    monkeypatch.setattr(tseg, "segment_csr_bwd_plain", lambda *a, **k: (
        bwd.append(a[0].shape) or inner_b(*a, **k)))
    model = tpv.PVCNNSeg(5, 4, channels=(8, 16, 16), resolutions=(8, 6, 4),
                         num_batches=B, device="cpu", seed=0)
    pos, batch_idx, valid, _, _ = _cloud()
    batch["pv_key_r4"] = tpv.normalize_to_grid(pos, batch_idx, valid, 4,
                                               B)[1]
    out = model.train()(batch_to_torch(batch, "cpu"))["logits"]
    cells = [B * r**3 + 1 for r in (8, 6, 4)]
    assert calls == [c for w, s in zip((4, 8, 16), cells) for c in (
        ((N, w), s, "sum"), ((N, 1), s, "sum"))]
    out.sum().backward()
    # autograd walks the blocks back to front
    assert bwd == [(cells[2], 16), (cells[1], 8)]


@pytest.fixture(scope="module", params=["bf16", "f32"])
def runs(request):
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "f32":
            f32_operands(mp, [jpv], [tpv])
        batch, labels = _batch()
        got, want = model_runs(
            jpv.PVCNNSeg(5, channels=CHANNELS, resolutions=RES,
                         num_batches=B),
            tpv.PVCNNSeg(5, 4, channels=CHANNELS, resolutions=RES,
                         num_batches=B, device="cpu", seed=None),
            batch, labels, batch["valid"], jit=request.param == "f32")
    return got, want, batch


def test_pvcnn_seg_matches_jax(runs):
    got, want, batch = runs
    assert got["logits"].shape == want["logits"].shape == (N, 5)
    # the padding rows too: their batch_idx clamps into the grid, as a JAX
    # gather clamps it
    assert_model_close(got, want, slice(None), MODEL_RTOL)


def test_seeded_init_under_the_flax_names(runs):
    batch = runs[2]
    make = lambda: tpv.PVCNNSeg(5, 4, channels=CHANNELS,  # noqa: E731
                                resolutions=RES, num_batches=B, device="cpu",
                                seed=6)
    a, b = make(), make()
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert_same_tree(a, jpv.PVCNNSeg(5, channels=CHANNELS, resolutions=RES,
                                     num_batches=B), batch, train=False)
    # flax's GroupNorm: eps 1e-6, min(8, C) groups
    assert a.PVConv_0.GroupNorm_0.eps == 1e-6
    assert a.PVConv_1.GroupNorm_1.num_groups == 8
