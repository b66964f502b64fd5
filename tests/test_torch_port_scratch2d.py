"""The scratch 2D stack of the PyTorch port against the JAX package: the
reference-exact ``modules/scratch2d.py`` (weight-standardized convs, the
transposed conv, ResBlocks, ResNet down / up stages, the 1x1 ``last`` conv
and the compact ``UNetWS`` of the published light no3d tower) and the
configurable ``UNet2D`` of ``modules/image_encoders.py``.

Float32 activations at sizes that are odd or not powers of two.  The
transposed convolution is held to 1e-6 (one layer, only summation orders
differ), the modules and whole towers to 1e-5 of the largest magnitude,
their input gradients to 1e-5 and their parameter gradients to 1e-4.
Parameters move by ``from_jax`` both ways: the JAX transposed kernel
``[kh, kw, in, out]`` (flipped inside the JAX module) becomes the torch
weight ``[in, out, kh, kw]`` unflipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.modules import scratch2d as js
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import scratch2d as ts
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, flat_leaves,  # noqa: F401
                             jax_variables, rel_err)


def _maps(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pair(jmod, tmod, xs, seed=1, grads=False, **kw):
    """The JAX module (NHWC) and the torch one (NCHW) on the same inputs
    ``xs`` from the same converted variables (``kw`` goes to the JAX call);
    with ``grads`` also the gradients of ``sum(out * cot)`` in the inputs
    and in the parameters."""
    variables = jax_variables(jmod, *xs, seed=seed, **kw)
    load_flax_variables(tmod, variables)
    tmod.eval()
    apply = jax.jit(lambda v, *ys: jmod.apply(v, *ys, **kw))
    ref = np.asarray(apply(variables, *map(jnp.asarray, xs)))
    ts_in = [_nchw(x).requires_grad_(grads) for x in xs]
    got = tmod(*ts_in)
    out = {"ref": ref, "got": _nhwc(got)}
    if grads:
        cot = _maps(ref.shape, seed + 7)

        def loss(params, *ys):
            return jnp.sum(apply(dict(variables, params=params), *ys) * cot)

        g = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs) + 1))))(
            variables["params"], *map(jnp.asarray, xs))
        (got * _nchw(cot)).sum().backward()
        out["ref_gx"] = [np.asarray(a) for a in g[1:]]
        out["got_gx"] = [_nhwc(t.grad) for t in ts_in]
        out["ref_gp"] = flat_leaves(jax.device_get(g[0]))
        out["got_gp"] = flat_leaves(to_flax_tree(tmod, "grads"))
    return out


def _assert_close(out, fwd=1e-5, gx=1e-5, gp=1e-4):
    assert out["got"].shape == out["ref"].shape
    assert rel_err(out["got"], out["ref"]) <= fwd
    for a, b in zip(out.get("got_gx", ()), out.get("ref_gx", ())):
        assert rel_err(a, b) <= gx
    if "ref_gp" in out:
        assert sorted(out["got_gp"]) == sorted(out["ref_gp"])
        bad = {k: rel_err(out["got_gp"][k], v)
               for k, v in out["ref_gp"].items()
               if not rel_err(out["got_gp"][k], v) <= gp}
        assert not bad, bad


# --- single layers ----------------------------------------------------------

@pytest.mark.parametrize("k,s,p,standardize", [
    (3, 1, 1, True), (3, 2, 1, True), (2, 2, 0, True), (1, 1, 0, False)],
    ids=["3x3", "3x3-stride2", "2x2-stride2", "1x1-plain"])
def test_ws_conv2d_matches_jax(k, s, p, standardize):
    x = _maps((2, 13, 7, 5))
    jm = js.WSConv2d(6, k, s, p, standardize=standardize)
    tm = ts.WSConv2d(5, 6, k, s, p, standardize=standardize)
    _assert_close(_pair(jm, tm, [x], grads=True))


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 1)],
                         ids=["2x2-stride2", "3x3-stride2", "3x3"])
def test_ws_conv_transpose2d_matches_jax(k, s, p):
    """The kernel's layout and flip: a transposed conv at an odd size, held
    to 1e-6; the weight the torch module holds is the JAX kernel read as
    ``[in, out, kh, kw]``, not flipped."""
    x = _maps((2, 9, 5, 6))
    jm = js.WSConvTranspose2d(4, k, s, p)
    tm = ts.WSConvTranspose2d(6, 4, k, s, p)
    out = _pair(jm, tm, [x], grads=True)
    assert out["got"].shape == ((2, (9 - 1) * s - 2 * p + k,
                                 (5 - 1) * s - 2 * p + k, 4))
    _assert_close(out, fwd=1e-6, gx=1e-6)
    kernel = jax_variables(jm, x, seed=1)["params"]["kernel"]
    np.testing.assert_array_equal(tm.weight.detach().numpy(),
                                  kernel.transpose(2, 3, 0, 1))


def test_unstandardized_transposed_conv_is_torchs():
    """Without standardization the module is ``conv_transpose2d`` of the
    converted weight: the JAX dilated-input conv of the flipped kernel
    computes the same (stride 2, odd size)."""
    x = _maps((1, 7, 5, 3))
    jm = js.WSConvTranspose2d(4, 3, 2, 1, standardize=False)
    tm = ts.WSConvTranspose2d(3, 4, 3, 2, 1, standardize=False)
    out = _pair(jm, tm, [x])
    want = torch.nn.functional.conv_transpose2d(
        _nchw(x), tm.weight, tm.bias, stride=2, padding=1)
    assert rel_err(out["ref"], _nhwc(want)) <= 1e-6


@pytest.mark.parametrize("features,transpose", [(8, False), (6, False),
                                                (6, True)],
                         ids=["same-width", "shortcut", "transpose"])
def test_ref_res_block_matches_jax(features, transpose):
    x = _maps((2, 11, 6, 8))
    jm = js.RefResBlock(features, transpose=transpose)
    tm = ts.RefResBlock(8, features, transpose=transpose)
    assert (tm.down_conv is not None) == (features != 8)
    _assert_close(_pair(jm, tm, [x], grads=True, train=False))


@pytest.mark.parametrize("cfg", [(16, 24, 2, 2, 0, 2), (16, 24, 3, 1, 1, 0),
                                 (16, 24, 3, 2, 1, 1)],
                         ids=["stride2-2blocks", "noblock", "3x3-stride2"])
def test_resnet_down_matches_jax(cfg):
    x = _maps((2, 13, 10, 16))
    jm = js.ResNetDown2D(*cfg)
    tm = ts.ResNetDown2D(16, *cfg)
    _assert_close(_pair(jm, tm, [x], grads=True, train=False))


def test_resnet_up_with_skip_matches_jax():
    x, skip = _maps((2, 6, 5, 16)), _maps((2, 12, 10, 8), 1)
    jm = js.ResNetUp2D(16, 12, 8, 2, 2, 0, 1)
    tm = ts.ResNetUp2D(16, 16, 12, 8, 2, 2, 0, 1)
    _assert_close(_pair(jm, tm, [x, skip], grads=True, train=False))


def test_resnet_up_without_skip_matches_jax():
    x = _maps((2, 7, 5, 12))
    jm = js.ResNetUp2D(12, 12, 0, 3, 1, 1, 1)
    tm = ts.ResNetUp2D(12, 12, 12, 0, 3, 1, 1, 1)

    class _NoSkip(torch.nn.Module):
        def __init__(self, up):
            super().__init__()
            self.up = up

    # the JAX module takes ``skip=None`` positionally
    variables = jax_variables(jm, x, None, seed=2, train=False)
    load_flax_variables(_NoSkip(tm), {"params": {"up": variables["params"]}})
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), None, train=False))
    with torch.no_grad():
        got = _nhwc(tm.eval()(_nchw(x), None))
    assert rel_err(got, ref) <= 1e-5


def test_unary_conv_matches_jax_and_draws_its_dropout():
    x = _maps((3, 9, 7, 8))
    jm = js.UnaryConv2D(5, in_drop=0.5)
    tm = ts.UnaryConv2D(8, 5, in_drop=0.5)
    # eval (and training without a generator): no dropout
    _assert_close(_pair(jm, tm, [x], train=False))
    assert tm.drop.per_image
    masks = []
    tm.drop.register_forward_hook(lambda m, i, o: masks.append(m.mask))
    gen = torch.Generator().manual_seed(0)
    images = torch.from_numpy(x)
    y = tt.run_tower(tm, images, train=True, bf16=False, generator=gen)
    plain = tt.run_tower(tm, images, train=True, bf16=False)
    # training with a generator: a channel mask per image, kept channels
    # scaled by 1 / (1 - p); the mask is dropped after the call
    (mask,), keep = masks[:1], masks[0].to(torch.float32) * 2.0
    assert mask.shape == (3, 8, 1, 1) and masks[1] is None
    want = tm.conv(images.permute(0, 3, 1, 2) * keep).permute(0, 2, 3, 1)
    assert torch.allclose(y, want) and not torch.equal(y, plain)
    assert tm.drop.mask is None


# --- towers -----------------------------------------------------------------

def test_light_unetws_matches_jax():
    """The published light no3d tower (``Res16UNet21-15_light``'s
    ``tower_cfg`` at 13 classes) on 48 x 80 images: its deepest maps are 3 x
    5 cells.  The forward within 1e-5.  Its gradients are ill-conditioned in
    float32: the input gradient of either package lies 1.6e-3 from a float64
    evaluation of the same tower, single leaves (the biases and scales
    before a group norm of the up path) up to 8e-3; the packages are held to
    5e-3 and 2e-2 of each other."""
    cfg = jzoo.get_model_spec("Res16UNet21-15_light", 13, 4).branches[0][1] \
        .tower_cfg
    tcfg = tzoo.get_model_spec("Res16UNet21-15_light", 13, 4).branches[0][1] \
        .tower_cfg
    assert tcfg == cfg
    x = _maps((2, 48, 80, 3))
    jm = js.unetws_from_cfg(cfg)
    tm = ts.unetws_from_cfg(tcfg)
    out = _pair(jm, tm, [x], grads=True, train=False)
    assert out["got"].shape == (2, 48, 80, 13)
    _assert_close(out, gx=5e-3, gp=2e-2)
    assert tm.out_channels == ts.tower_cfg_out_channels(tcfg) == 13


def test_unetws_params_round_trip_and_names():
    cfg = tzoo.get_model_spec("Res16UNet21-15_light", 13, 4).branches[0][1] \
        .tower_cfg
    x = _maps((1, 16, 16, 3))
    variables = jax_variables(js.unetws_from_cfg(cfg), x, seed=3,
                              train=False)
    tm = ts.unetws_from_cfg(cfg)
    load_flax_variables(tm, variables)
    back = flat_leaves(to_flax_tree(tm, "params"))
    want = flat_leaves(variables["params"])
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
    assert {k.split("/")[0] for k in want} == {
        "down0", "down1", "down2", "down3", "down4", "up0", "up1", "up2",
        "up3", "up4", "last"}
    assert "up0/block0/conv1/kernel" in want       # a transposed ResBlock
    assert "up0/block0/down_conv/kernel" in want   # its plain shortcut


_UNET2D = {"unet2d": dict(out_channels=32),
           "unet2d_light": dict(down_widths=(32, 32, 64, 128, 256),
                                up_widths=(128, 96, 64, 32), out_channels=32)}


@pytest.mark.parametrize("name,size", [("unet2d", (13, 7)),
                                       ("unet2d_light", (40, 24))])
def test_unet2d_matches_jax(name, size):
    """Odd and non-power-of-two sizes: the up path's bilinear resize goes
    from 7 x 4 to 13 x 7 (``unet2d``) and from 3 x 2 to 5 x 3
    (``unet2d_light``)."""
    from deepviewagg_tpu.models import segmentation as jseg

    assert jseg.make_tower(name)[1] == 32
    tower, tc = tseg.make_tower(name, device="cpu")
    assert tc == 32
    jm = jt.UNet2D(**_UNET2D[name])
    x = _maps((2,) + size + (3,))
    with jt.f32_convs(), tt.f32_convs():
        _assert_close(_pair(jm, tower, [x], train=False))


def test_unet2d_dropout_takes_one_mask_for_the_batch():
    tower = tt.UNet2D(down_widths=(8, 16), up_widths=(8,), out_channels=4,
                      dropout=0.5)
    tseg.init_parameters(tower, torch.Generator().manual_seed(0))
    images = torch.from_numpy(_maps((3, 12, 10, 3)))
    seen = []
    tower.drop.register_forward_hook(lambda m, i, o: seen.append(
        None if m.mask is None else m.mask.clone()))
    gen = torch.Generator().manual_seed(1)
    a = tt.run_tower(tower, images, train=True, bf16=False, generator=gen)
    # the same generator state under full remat: the same mask and output
    gen = torch.Generator().manual_seed(1)
    images.requires_grad_(True)
    b = tt.run_tower(tower, images, train=True, bf16=False, remat=True,
                     generator=gen)
    b.sum().backward()
    # the forward, the remat forward and its recomputation in the backward
    assert len(seen) == 3 and seen[0].shape == (1, 8, 1, 1)
    assert torch.equal(seen[0], seen[1]) and torch.equal(seen[1], seen[2])
    assert torch.equal(a, b.detach())
    # eval and no generator: identity
    c = tt.run_tower(tower, images.detach(), train=False, bf16=False,
                     generator=gen)
    d = tt.run_tower(tower, images.detach(), train=True, bf16=False)
    assert not torch.equal(a, d) and torch.equal(c, d)


def test_scratch_convs_take_the_flax_initializer_family():
    """variance_scaling(1/3, fan_in, uniform): limits sqrt(1 / fan_in) with
    the transposed kernel's fan in over its out channels, zero biases."""
    tm = ts.unetws_from_cfg(tzoo.get_model_spec(
        "Res16UNet21-15_light", 13, 4).branches[0][1].tower_cfg)
    tseg.init_parameters(tm, torch.Generator().manual_seed(0))
    for m in (tm.down1.conv_in, tm.up0.conv_in, tm.up0.block0.conv1,
              tm.last.conv):
        w = m.weight.detach()
        limit = float(np.sqrt(1.0 / w[0].numel()))
        assert float(w.abs().max()) <= limit
        assert abs(float(w.var()) - limit ** 2 / 3) <= 0.15 * limit ** 2 / 3
        assert not m.bias.any()
    again = ts.unetws_from_cfg(tzoo.get_model_spec(
        "Res16UNet21-15_light", 13, 4).branches[0][1].tower_cfg)
    tseg.init_parameters(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 again.parameters()))
