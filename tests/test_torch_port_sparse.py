"""The sparse-voxel 3D path of the PyTorch port against the JAX package, on
the graph of the JAX package's tiny flagship batch: the three sparse
convolutions, ``MaskedBatchNorm`` (eval), ``ResBlock`` and the Res16UNet
stages on ``Res16UNetTest``.  Both sides round the conv operands to bf16 and
accumulate in float32, so one conv differs only in summation order: 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.nn import norm as jnorm
from deepviewagg_tpu.nn import res16unet as jres
from deepviewagg_tpu.nn import sparse_blocks as jblocks
from deepviewagg_tpu.ops import sparse_conv as jsc
from deepviewagg_tpu_torch.nn import norm as tnorm
from deepviewagg_tpu_torch.nn import res16unet as tres
from deepviewagg_tpu_torch.nn import sparse_blocks as tblocks
from deepviewagg_tpu_torch.ops import sparse_conv as tsc
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             jax_tiny_batch, jax_variables, rel_err,
                             torch_batch)

# a chain of bf16-operand convs drifts by rounding flips (f32_sparse_convs):
# the blocks are held to 1e-5 in float32 and to 3e-4 with bf16 operands,
# well below the ~2e-3 that skipping or misplacing the rounding gives
_CHAIN_TOL = {"f32": 1e-5, "bf16": 3e-4}


def _graph():
    batch, _ = jax_tiny_batch()
    return batch["graph"], torch_batch({"g": batch["graph"]})["g"]


def _feats(n, c, seed=0):
    return np.random.default_rng(seed).normal(size=(n, c)).astype(np.float32)


def _weights(k, cin, cout, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)


@pytest.mark.parametrize("kind", ["conv0", "sub", "down", "up"])
def test_sparse_convs_match_jax(kind):
    jg, tg = _graph()
    lv0, lv1 = jg["levels"][0], jg["levels"][1]
    nbr, n_in, fn = {
        "conv0": (jg["conv0_nbr"], len(lv0["valid"]), "plain"),
        "sub": (lv1["sub_nbr"], len(lv1["valid"]), "subm"),
        "down": (lv0["down_nbr"], len(lv0["valid"]), "pair"),
        "up": (lv0["up_nbr"], len(lv1["valid"]), "pair"),
    }[kind]
    nbr_t = {"down": lv0["up_nbr"], "up": lv0["down_nbr"]}.get(kind)
    x = _feats(n_in, 12)
    w = _weights(nbr.shape[0], 12, 20)
    jx, jw, jn = jnp.asarray(x), jnp.asarray(w), jnp.asarray(nbr)
    tx, tw, tn = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(nbr)
    if fn == "plain":
        ref = jsc.sparse_conv(jx, jw, jn)
        got = tsc.sparse_conv(tx, tw, tn)
    elif fn == "subm":
        ref = jsc.sparse_conv_submanifold(jx, jw, jn)
        got = tsc.sparse_conv_submanifold(tx, tw, tn)
    else:
        ref = jsc.sparse_conv_pair(jx, jw, jn, jnp.asarray(nbr_t))
        got = tsc.sparse_conv_pair(tx, tw, tn, torch.from_numpy(nbr_t))
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(got.numpy(), ref) <= 1e-5
    # rows of the dump slot only: padding outputs are exactly 0
    pad = (nbr == n_in).all(axis=0)
    assert np.abs(got.numpy()[pad]).max(initial=0.0) == 0.0


def test_masked_batch_norm_eval_matches_jax():
    x = _feats(300, 24, seed=2) * 3.0 + 1.0
    valid = np.random.default_rng(3).random(300) > 0.3
    jbn = jnorm.MaskedBatchNorm()
    variables = jax_variables(jbn, x, valid, seed=5, train=False)
    tbn = tnorm.MaskedBatchNorm(24).eval()
    load_flax_variables(tbn, variables)
    ref = np.asarray(jbn.apply(variables, x, valid, train=False))
    with torch.no_grad():
        got = tbn(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    assert rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("operands", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(16, 16), (12, 20)])
def test_res_block_matches_jax(cin, cout, operands, monkeypatch):
    if operands == "f32":
        f32_sparse_convs(monkeypatch)
    jg, tg = _graph()
    lv = jg["levels"][1]
    x = _feats(len(lv["valid"]), cin, seed=4)
    jblk = jblocks.ResBlock(cout)
    args = (x, lv["sub_nbr"], lv["valid"])
    variables = jax_variables(jblk, *args, seed=6, train=False)
    tblk = tblocks.ResBlock(cin, cout).eval()
    load_flax_variables(tblk, variables)
    ref = np.asarray(jblk.apply(variables, *args, train=False))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), tg["levels"][1]["sub_nbr"],
                   tg["levels"][1]["valid"]).numpy()
    assert rel_err(got, ref) <= _CHAIN_TOL[operands]


class _TorchUNet(torch.nn.Module):
    """The port's Res16UNet stages chained as the JAX ``Res16UNet`` chains
    them (flax names ``Stem_0``, ``DownStage_i``, ``UpStage_j``)."""

    def __init__(self, arch, in_channels):
        super().__init__()
        layers, planes, block = tres.RES16_PRESETS[arch]
        self.n = n = len(layers) // 2
        self.Stem_0 = tres.Stem(in_channels, 32, 3)
        c, skip_c = 32, [32]
        for i in range(n):
            setattr(self, f"DownStage_{i}",
                    tres.DownStage(c, planes[i], layers[i], block))
            c = planes[i]
            if i < n - 1:
                skip_c.append(c)
        for j in range(n):
            setattr(self, f"UpStage_{j}", tres.UpStage(
                c, skip_c[n - 1 - j], planes[n + j], layers[n + j], block))
            c = planes[n + j]

    def forward(self, x, graph):
        x = self.Stem_0(x, graph)
        skips = [x]
        for i in range(self.n):
            x = getattr(self, f"DownStage_{i}")(x, graph, i)
            if i < self.n - 1:
                skips.append(x)
        for j in range(self.n):
            lvl = self.n - 1 - j
            x = getattr(self, f"UpStage_{j}")(x, skips[lvl], graph, lvl)
        return x


@pytest.mark.parametrize("operands", ["f32", "bf16"])
def test_res16unet_matches_jax(operands, monkeypatch):
    if operands == "f32":
        f32_sparse_convs(monkeypatch)
    jg, tg = _graph()
    x = _feats(len(jg["levels"][0]["valid"]), 4, seed=7)
    jnet = jres.Res16UNet.preset("Res16UNetTest")
    variables = jax_variables(jnet, x, jg, seed=8, train=False)
    tnet = _TorchUNet("Res16UNetTest", 4).eval()
    load_flax_variables(tnet, variables)
    ref = np.asarray(jnet.apply(variables, x, jg, train=False))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), tg).numpy()
    n = int(jg["levels"][0]["valid"].sum())
    assert got.shape == ref.shape
    assert rel_err(got[:n], ref[:n]) <= _CHAIN_TOL[operands]
