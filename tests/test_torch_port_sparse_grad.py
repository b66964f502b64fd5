"""Gradients of the port's sparse convolutions against the JAX package's
custom VJPs (``_subm_bwd`` / ``_pair_bwd``), on the graph of the JAX
package's tiny flagship batch.  Both sides round the cotangent, the weights
and the re-gathered rows to ``compute_dtype`` and accumulate in float32, so
one gradient differs only in summation order: 1e-6 relative with float32
operands, 1e-5 with bf16 operands (an operand that sits on a rounding
boundary may round the other way after a differently ordered sum upstream;
here the inputs are the same bits, so only the accumulation differs, but the
bf16 products carry fewer matching low bits).  And the backward saves only
``(feats, weights, nbr[, nbr_t])``: no im2col.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.ops import sparse_conv as jsc
from deepviewagg_tpu_torch.ops import sparse_conv as tsc
from torch_port_util import (_torch_threads, backward_node_names,  # noqa: F401
                             jax_tiny_batch, rel_err)

_TOL = {"f32": 1e-6, "bf16": 1e-5}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(kind, cin=12, cout=20):
    graph = jax_tiny_batch()[0]["graph"]
    lv0, lv1 = graph["levels"][0], graph["levels"][1]
    nbr, nbr_t, n_in = {
        "conv0": (graph["conv0_nbr"], None, len(lv0["valid"])),
        "sub": (lv1["sub_nbr"], None, len(lv1["valid"])),
        "down": (lv0["down_nbr"], lv0["up_nbr"], len(lv0["valid"])),
        "up": (lv0["up_nbr"], lv0["down_nbr"], len(lv1["valid"])),
    }[kind]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(nbr.shape[0], cin, cout))
         / np.sqrt(nbr.shape[0] * cin)).astype(np.float32)
    cot = rng.normal(size=(nbr.shape[1], cout)).astype(np.float32)
    return x, w, nbr, nbr_t, cot


def _run_torch(x, w, nbr, nbr_t, cot, dtype):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    if nbr_t is None:
        out = tsc.sparse_conv_submanifold(xt, wt, torch.from_numpy(nbr), dtype)
    else:
        out = tsc.sparse_conv_pair(xt, wt, torch.from_numpy(nbr),
                                   torch.from_numpy(nbr_t), dtype)
    out.backward(torch.from_numpy(cot))
    return out, xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("operands", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["conv0", "sub", "down", "up"])
def test_sparse_conv_grads_match_jax_vjps(kind, operands):
    x, w, nbr, nbr_t, cot = _case(kind)
    jdt, tdt = _DT[operands]
    if nbr_t is None:
        def fn(a, b):
            return jsc.sparse_conv_submanifold(a, b, jnp.asarray(nbr), jdt)
    else:
        def fn(a, b):
            return jsc.sparse_conv_pair(a, b, jnp.asarray(nbr),
                                        jnp.asarray(nbr_t), jdt)
    ref_x, ref_w = jax.grad(lambda a, b: jnp.sum(fn(a, b) * cot),
                            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _, got_x, got_w = _run_torch(x, w, nbr, nbr_t, cot, tdt)
    assert got_x.shape == x.shape and got_w.shape == w.shape
    assert rel_err(got_x, np.asarray(ref_x)) <= _TOL[operands]
    assert rel_err(got_w, np.asarray(ref_w)) <= _TOL[operands]


@pytest.mark.parametrize("kind", ["sub", "down", "up"])
def test_gather_only_backward_is_the_true_gradient_in_float32(kind):
    """With float32 operands nothing is rounded, so the custom backward must
    equal ordinary autograd of the plain conv (the transposed map really is
    the transpose)."""
    x, w, nbr, nbr_t, cot = _case(kind)
    _, got_x, got_w = _run_torch(x, w, nbr, nbr_t, cot, torch.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tsc.sparse_conv(xt, wt, torch.from_numpy(nbr),
                    compute_dtype=torch.float32).backward(torch.from_numpy(cot))
    assert rel_err(got_x, xt.grad.numpy()) <= 1e-6
    assert rel_err(got_w, wt.grad.numpy()) <= 1e-6


def test_bf16_backward_rounds_the_cotangent():
    """The cotangent is rounded to bf16 before both products, as in the JAX
    backward; plain autograd through the rounded forward would pass it
    unrounded."""
    x, w, nbr, nbr_t, cot = _case("sub")
    _, gx, gw = _run_torch(x, w, nbr, nbr_t, cot, torch.bfloat16)
    cot_r = torch.from_numpy(cot).to(torch.bfloat16).to(torch.float32).numpy()
    _, gx_r, gw_r = _run_torch(x, w, nbr, nbr_t, cot_r, torch.bfloat16)
    np.testing.assert_array_equal(gx, gx_r)
    np.testing.assert_array_equal(gw, gw_r)
    assert np.abs(cot - cot_r).max() > 0


@pytest.mark.parametrize("kind", ["sub", "down"])
def test_backward_saves_no_im2col(kind):
    x, w, nbr, nbr_t, cot = _case(kind)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _, _ = _run_torch(x, w, nbr, nbr_t, cot, torch.bfloat16)
    want = [x.shape, w.shape, nbr.shape] + ([nbr_t.shape] if nbr_t is not None
                                            else [])
    assert sorted(saved) == sorted(tuple(s) for s in want), saved
    im2col = (nbr.shape[1], nbr.shape[0] * x.shape[1])
    assert im2col not in saved


def test_conv_modules_pick_the_custom_backward():
    """The blocks route as the JAX package's do: ResBlock and Stem convs are
    submanifold, the strided down / up convs use their transpose map."""
    from deepviewagg_tpu_torch.data.collate import batch_to_torch
    from deepviewagg_tpu_torch.nn import res16unet as tres

    graph = batch_to_torch({"g": jax_tiny_batch()[0]["graph"]}, "cpu")["g"]
    n0 = graph["levels"][0]["valid"].shape[0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n0, 4, generator=gen)

    names = backward_node_names
    stem = tres.Stem(4, 8, 3)
    down = tres.DownStage(8, 8, 1)
    up = tres.UpStage(8, 8, 8, 1)
    for m in (stem, down, up):
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.1)
    y0 = stem(x, graph)
    y1 = down(y0, graph, 0)
    y2 = up(y1, y0, graph, 0)
    assert sum("_SubmanifoldConv" in n for n in names(y0)) == 1
    assert sum("_PairConv" in n for n in names(y1)) == 1
    assert sum("_PairConv" in n for n in names(y2)) == 2
    assert sum("_SubmanifoldConv" in n for n in names(y2)) == 5
