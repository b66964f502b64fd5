"""The 2D image tower of the PyTorch port against the JAX package:
``Conv2dWS``, the dilated-8 ResNet18 + PPM (``ResNet18PPM``) and the
truncated ``ResNet18``, driven through each package's ``run_tower`` on the
same numpy images with parameters converted by ``from_jax``."""

import numpy as np
import pytest
import torch
from flax import linen as fnn

from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import _torch_threads, jax_variables, rel_err  # noqa: F401


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("strides,dilation", [((2, 2), (1, 1)),
                                              ((1, 1), (2, 2)),
                                              ((2, 2), (2, 2))])
def test_conv2d_ws_matches_jax(strides, dilation):
    x = _images((2, 17, 12, 5))
    jconv = jt.Conv2dWS(7, (3, 3), strides, dilation)
    variables = jax_variables(jconv, x, seed=3)
    tconv = tt.Conv2dWS(5, 7, (3, 3), strides, dilation)
    load_flax_variables(tconv, variables)
    with jt.f32_convs():
        ref = np.asarray(jconv.apply(variables, x))
    with torch.no_grad(), tt.f32_convs():
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-5


class _JaxRun(fnn.Module):
    """The JAX branch's tower call: ``run_tower`` on a tower named 'tower'."""

    make: object
    bf16: bool

    @fnn.compact
    def __call__(self, images):
        return jt.run_tower(self.make(name="tower"), images, False,
                            remat=False, bf16=self.bf16)


class _TorchRun(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.tower = tower


_TOWERS = {
    "resnet18_ppm": (lambda name: jt.ResNet18PPM(out_channels=128, name=name),
                     lambda: tt.ResNet18PPM(out_channels=128, device="cpu")),
    "resnet18_l2": (lambda name: jt.ResNet18(out_level=2, name=name),
                    lambda: tt.ResNet18(out_level=2, device="cpu")),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("tower", sorted(_TOWERS))
def test_tower_matches_jax(tower, bf16):
    # 64 x 32 images: the dilated trunk gives 8 x 4 maps, so PPM's 3- and
    # 6-bin SAME-padded pools have windows that do not divide the map
    images = _images((2, 64, 32, 3), seed=1)
    jmake, tmake = _TOWERS[tower]
    jrun = _JaxRun(jmake, bf16)
    variables = jax_variables(jrun, images, seed=4)
    trun = _TorchRun(tmake()).eval()
    load_flax_variables(trun, variables)
    if bf16:
        ref = np.asarray(jrun.apply(variables, images))
        with torch.no_grad():
            got = tt.run_tower(trun.tower, torch.from_numpy(images), bf16=True)
    else:
        with jt.f32_convs():
            ref = np.asarray(jrun.apply(variables, images))
        with torch.no_grad(), tt.f32_convs():
            got = tt.run_tower(trun.tower, torch.from_numpy(images), bf16=False)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    # f32: only summation orders differ; bf16: activations round at other
    # places in the two frameworks
    assert rel_err(got, ref) <= (2e-2 if bf16 else 1e-4)
