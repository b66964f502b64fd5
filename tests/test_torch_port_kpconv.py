"""The port's KPConv (``nn/kpconv.py``) against the JAX package's, on the
same numpy inputs from the same converted flax variables: the kernel point
dispositions, ``KPConvLayer`` alone and ``KPConvSeg`` whole on a
one-sample graph built by the JAX package.

Both products of the layer take bf16 operands in both packages (the
influence-weighted sum with a bf16 result, the contraction with the
``[K, Cin, Cout]`` kernel with float32 accumulation); the port runs them as
float32 GEMMs of bf16-rounded operands, rounding at the same casts, so the
two round the same values and differ in summation order only: the layer
agrees to 1e-5 and the model to 1e-4 of the largest magnitude in bf16 as
well as with float32 operands (``f32_operands``; 5.5e-7 measured on every
gradient leaf of the model in bf16).  A summation-order difference that
flips a bf16 rounding would move a value by 2^-8 of itself; none does on
these inputs.  The bf16 cases run the JAX module op by op, where every
cast rounds as written (under ``jax.jit`` XLA may keep a bf16 product's
result in float32).
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import kpconv as jkp
from deepviewagg_tpu_torch.nn import kpconv as tkp
from torch_port_backbones import (assert_layer_close, assert_model_close,
                                  assert_same_tree, f32_operands,
                                  graph_batch, layer_runs, model_runs,
                                  neighbourhood)
from torch_port_util import _torch_threads  # noqa: F401

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
CHANNELS, RADII = (16, 32), (0.4, 0.8)


@pytest.mark.parametrize("num_points,radius,iters,seed", [
    (15, 1.0, 100, 0), (15, 0.264, 100, 0), (12, 0.5, 40, 3)])
def test_kernel_point_dispositions_are_byte_equal(num_points, radius, iters,
                                                  seed):
    want = jkp.kernel_point_dispositions(num_points, radius, iters, seed)
    got = tkp.kernel_point_dispositions(num_points, radius, iters, seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("operands", ["bf16", "f32"])
@pytest.mark.parametrize("train", [True, False])
def test_kpconv_layer_matches_jax(operands, train, monkeypatch):
    if operands == "f32":
        f32_operands(monkeypatch, [jkp], [tkp])
    feats, rel, idx, count, valid = neighbourhood(m=150, k=10, p=300, c=6)
    cot = np.random.default_rng(2).normal(size=(150, 12)).astype(np.float32)
    got, want = layer_runs(jkp.KPConvLayer(12, radius=0.3),
                           tkp.KPConvLayer(6, 12, radius=0.3, device="cpu"),
                           (feats, rel, idx, count, valid), cot, train=train,
                           jit=operands == "f32")
    assert_layer_close(got, want, LAYER_RTOL)
    assert (got["out"][~valid] == 0).all()


@pytest.fixture(scope="module", params=["bf16", "f32"])
def runs(request):
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "f32":
            f32_operands(mp, [jkp], [tkp])
        batch, labels = graph_batch()
        got, want = model_runs(
            jkp.KPConvSeg(5, channels=CHANNELS, radii=RADII),
            tkp.KPConvSeg(5, 4, channels=CHANNELS, radii=RADII, device="cpu",
                          seed=None),
            batch, labels, batch["valid"], jit=request.param == "f32")
    return got, want, batch["valid"]


def test_kpconv_seg_matches_jax(runs):
    got, want, valid = runs
    assert got["logits"].shape == want["logits"].shape == (900, 5)
    assert_model_close(got, want, valid, MODEL_RTOL)


def test_kpconv_seg_refuses_a_graph_of_other_depth():
    batch, _ = graph_batch(n_points=(160,), radii=(0.4,))
    model = tkp.KPConvSeg(5, 4, channels=CHANNELS, radii=RADII, device="cpu")
    from deepviewagg_tpu_torch.data.collate import batch_to_torch

    with pytest.raises(ValueError, match="levels"):
        model(batch_to_torch(batch, "cpu"))


def test_seeded_init_is_reproducible_under_the_flax_names():
    a = tkp.KPConvSeg(5, 4, channels=CHANNELS, radii=RADII, device="cpu",
                      seed=7)
    b = tkp.KPConvSeg(5, 4, channels=CHANNELS, radii=RADII, device="cpu",
                      seed=7)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    # the flax tree's shapes, leaf for leaf (the kernel as it is)
    batch, _ = graph_batch()
    assert_same_tree(a, jkp.KPConvSeg(5, channels=CHANNELS, radii=RADII),
                     batch, train=False)
    assert a.kp0.weight.shape == (15, 4, 16)
    # He-normal kernels, fan in K * Cin
    std = float(a.kp1.weight.detach().std())
    assert 0.5 < std * np.sqrt(15 * 16 / 2) < 1.5
