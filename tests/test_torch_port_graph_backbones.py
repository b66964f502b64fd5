"""The port's RSConv, PointCNN and PPNet (``nn/rsconv.py``,
``nn/pointcnn.py``, ``nn/ppnet.py``) against the JAX package's, on the same
numpy inputs from the same converted flax variables: each layer alone, each
model whole on a one-sample graph built by the JAX package (with the same-
level ``self_group`` tables for PPNet's bottlenecks).

Bounds.  RSConv and PPNet are float32 throughout: 1e-5 of the largest
magnitude for a layer, 1e-4 for a model (ROADMAP C), on outputs, every
gradient leaf and every running statistic.  PointCNN's X-transform takes
bf16 operands and gives a bf16 result in both packages; the port rounds at
the same casts, so with float32 operands (``f32_operands``) the two differ
in summation order only and are held at those bounds.  With bf16 operands a
summation-order difference can flip the bf16 rounding of a product or of
its cotangent by one step, 2^-8 of the value: the layer and the model's
outputs, loss and running statistics stay at 1e-4, the gradients (leaves
and the layer's input) are held at 1e-2, a few such steps (1.4e-3 measured,
on ``xconv0/Dense_3/kernel``). The bf16 cases run the JAX module op by op:
under ``jax.jit`` XLA keeps the X-transform's result in float32 (its
excess-precision default) and the logits then lie 2.4e-3 from the port's
rounded ones.
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import pointcnn as jpc
from deepviewagg_tpu.nn import ppnet as jpp
from deepviewagg_tpu.nn import rsconv as jrs
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.nn import pointcnn as tpc
from deepviewagg_tpu_torch.nn import ppnet as tpp
from deepviewagg_tpu_torch.nn import rsconv as trs
from torch_port_backbones import (assert_bf16_layer_close,
                                  assert_layer_close, assert_model_close,
                                  assert_same_tree, f32_operands,
                                  graph_batch, layer_runs, leaf_errs,
                                  model_runs, neighbourhood)
from torch_port_util import _torch_threads, rel_err  # noqa: F401

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
BF16_GRAD_RTOL = 1e-2
K = 12                          # the graphs' neighbours per centre
CHANNELS = (16, 32)
PP_CHANNELS, RADII = (12, 24), (0.4, 0.8)


def _cot(shape, seed=2):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_rsconv_layer_matches_jax(train):
    args = neighbourhood(m=150, k=10, p=300, c=6)
    got, want = layer_runs(jrs.RSConvLayer(12),
                           trs.RSConvLayer(6, 12, device="cpu"), args,
                           _cot((150, 12)), train=train)
    assert_layer_close(got, want, LAYER_RTOL)


@pytest.mark.parametrize("operands", ["bf16", "f32"])
def test_xconv_layer_matches_jax(operands, monkeypatch):
    if operands == "f32":
        f32_operands(monkeypatch, [jpc], [tpc])
    args = neighbourhood(m=150, k=8, p=300, c=6)
    got, want = layer_runs(jpc.XConv(12), tpc.XConv(6, 12, 8, device="cpu"),
                           args, _cot((150, 12)), jit=operands == "f32")
    if operands == "f32":
        assert_layer_close(got, want, LAYER_RTOL)
    else:
        assert_bf16_layer_close(got, want, MODEL_RTOL, BF16_GRAD_RTOL)
    # invalid centres read 0 after the ReLU
    assert (got["out"][~args[4]] == 0).all()


def test_xconv_refuses_another_neighbourhood_size():
    feats, rel, idx, count, valid = (torch.from_numpy(a) for a in
                                     neighbourhood(m=20, k=8, p=40, c=6))
    with pytest.raises(ValueError, match="neighbours"):
        tpc.XConv(6, 12, 10, device="cpu")(feats, rel, idx, count, valid)


@pytest.mark.parametrize("embedding,channels", [("xyz", 12), ("sin_cos", 12),
                                                ("sin_cos", 14)])
def test_position_prior_matches_jax(embedding, channels):
    rel = np.random.default_rng(1).uniform(-1, 1, (40, 9, 3)).astype(
        np.float32)
    want = np.asarray(jpp._position_prior(rel, channels, embedding))
    got = tpp._position_prior(torch.from_numpy(rel), channels,
                              embedding).numpy()
    assert got.shape == want.shape == (40, 9, channels)
    assert rel_err(got, want) <= LAYER_RTOL


@pytest.mark.parametrize("reduction", ["avg", "sum", "max"])
@pytest.mark.parametrize("embedding,cin,cout", [("xyz", 12, 24),
                                                ("sin_cos", 14, 14)])
def test_pospool_layer_matches_jax(reduction, embedding, cin, cout):
    feats, rel, idx, count, valid = neighbourhood(m=150, k=10, p=300, c=cin)
    # an index past the last row reads zeros (the JAX pad row)
    idx[:5, -2:] = 300
    got, want = layer_runs(
        jpp.PosPoolLayer(cout, 0.3, embedding, reduction),
        tpp.PosPoolLayer(cin, cout, 0.3, embedding, reduction,
                         device="cpu"),
        (feats, rel, idx, count, valid), _cot((150, cout)))
    assert_layer_close(got, want, LAYER_RTOL)


@pytest.mark.parametrize("cin,c,embedding", [(24, 24, "xyz"),
                                            (12, 24, "sin_cos")])
def test_bottleneck_layer_matches_jax(cin, c, embedding):
    args = neighbourhood(m=150, k=10, p=150, c=cin)
    got, want = layer_runs(jpp._Bottleneck(c, 0.6, embedding),
                           tpp._Bottleneck(cin, c, 0.6, embedding,
                                           device="cpu"), args,
                           _cot((150, c)))
    assert_layer_close(got, want, LAYER_RTOL)


# --- models -----------------------------------------------------------------

CASES = {
    "rsconv": lambda: (jrs.RSConvSeg(5, channels=CHANNELS),
                       trs.RSConvSeg(5, 4, channels=CHANNELS, device="cpu",
                                     seed=None), 0),
    "pointcnn_bf16": lambda: (jpc.PointCNNSeg(5, channels=CHANNELS),
                              tpc.PointCNNSeg(5, 4, K, channels=CHANNELS,
                                              device="cpu", seed=None), 0),
    "pointcnn_f32": lambda: (jpc.PointCNNSeg(5, channels=CHANNELS),
                             tpc.PointCNNSeg(5, 4, K, channels=CHANNELS,
                                             device="cpu", seed=None), 0),
    "ppnet_xyz_bottlenecks": lambda: (
        jpp.PPNetSeg(5, channels=PP_CHANNELS, radii=RADII),
        tpp.PPNetSeg(5, 4, channels=PP_CHANNELS, radii=RADII,
                     bottlenecks=True, device="cpu", seed=None), 6),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    jmodel, tmodel, self_k = CASES[request.param]()
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "pointcnn_f32":
            f32_operands(mp, [jpc], [tpc])
        batch, labels = graph_batch(self_k=self_k)
        got, want = model_runs(jmodel, tmodel, batch, labels, batch["valid"],
                               jit=request.param != "pointcnn_bf16")
    return request.param, got, want, batch["valid"]


def test_model_matches_jax(runs):
    name, got, want, valid = runs
    assert got["logits"].shape == want["logits"].shape == (900, 5)
    if name != "pointcnn_bf16":
        assert_model_close(got, want, valid, MODEL_RTOL)
        return
    for key in ("logits", "eval"):
        assert rel_err(got[key][valid], want[key][valid]) <= MODEL_RTOL, key
    assert abs(got["loss"] - want["loss"]) <= MODEL_RTOL * abs(want["loss"])
    errs = leaf_errs(got["grads"], want["grads"])
    assert max(errs.values()) <= BF16_GRAD_RTOL, errs
    errs = leaf_errs(got["stats"], want["stats"])
    assert max(errs.values()) <= MODEL_RTOL, errs


def test_ppnet_refuses_a_graph_that_disagrees_on_bottlenecks():
    for self_k, bottlenecks in ((0, True), (6, False)):
        batch, _ = graph_batch(self_k=self_k)
        model = tpp.PPNetSeg(5, 4, channels=PP_CHANNELS, radii=RADII,
                             bottlenecks=bottlenecks, device="cpu")
        with pytest.raises(ValueError, match="self_group"):
            model(batch_to_torch(batch, "cpu"))


SEEDED = {
    "rsconv": (lambda: jrs.RSConvSeg(5, channels=CHANNELS),
               lambda: trs.RSConvSeg(5, 4, channels=CHANNELS, device="cpu",
                                     seed=3)),
    "pointcnn": (lambda: jpc.PointCNNSeg(5, channels=CHANNELS),
                 lambda: tpc.PointCNNSeg(5, 4, K, channels=CHANNELS,
                                         device="cpu", seed=3)),
    "ppnet": (lambda: jpp.PPNetSeg(5, channels=PP_CHANNELS, radii=RADII),
              lambda: tpp.PPNetSeg(5, 4, channels=PP_CHANNELS, radii=RADII,
                                   bottlenecks=True, device="cpu", seed=3)),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_init_under_the_flax_names(name):
    batch, _ = graph_batch(self_k=6)
    jmodel, make = SEEDED[name]
    a, b = make(), make()
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert_same_tree(a, jmodel(), batch, train=False)
