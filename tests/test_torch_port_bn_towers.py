"""The BatchNorm towers of the PyTorch port (``norm='batch'``: the towers that
take pretrained weights) against the JAX package, through each package's
``run_tower``: every tower kind in training and eval mode on an image batch
whose last slot is zero padding; the running statistics under the three
remat modes (updated once); frozen towers (running statistics used and kept
bit for bit); the order of the updates over a crop-ladder batch's buckets;
and the crop-ladder tower's channel dropout, drawn per bucket call.

Float32 operands and activations (``f32_convs``, ``bf16=False``), so the
packages differ in summation order only.  One BatchNorm's output and updated
running statistics agree with flax's within 1e-6 on the same input; eval-mode
tower outputs within 1e-5 of the largest magnitude.  In training mode each
norm divides by its batch's standard deviation, and the per-channel means
deeper in a tower are sums that cancel, so the conv outputs' summation-order
noise grows layer by layer: the JAX package's float32 training-mode outputs
lie up to 7.5e-5 from a float64 evaluation of the same tower (its running
statistics up to 6.2e-6, ``resnet18_l4`` with the deep stem), the port's up
to 1.7e-5 (1.8e-6).  So a training-mode tower is held to the port's own
float64 run (outputs 2e-5, running statistics 2e-6) and to JAX (outputs
1e-4, running statistics 2e-5).  The ladder model's logits within 1e-4 (the
bound of ``test_torch_port_multibucket.py``).
"""

import dataclasses
from typing import Any

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import scratch2d as ts
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves, jax_ladder_batch,
                             jax_variables, rel_err, torch_batch)

# a small compact scratch tower (two down stages, one up stage, a 1x1 last
# conv with an input channel dropout per image)
_SCRATCH = (((4, 8, 3, 1, 1, 1), (8, 16, 2, 2, 0, 1)),
            ((16, 8, 8, 2, 2, 0, 1),), (8, 0.5, False))

# (tower, deep stem, tower_cfg)
_TOWERS = {
    "resnet18_l0-deep": ("resnet18_l0", True, None),
    "resnet18_l2": ("resnet18_l2", False, None),
    "resnet18_l4-deep": ("resnet18_l4", True, None),
    "resnet18_ppm-deep": ("resnet18_ppm", True, None),
    "resnet18_pyramid": ("resnet18_pyramid", False, None),
    "resnet18_pyramid_raw-deep": ("resnet18_pyramid_raw", True, None),
    "unet2d": ("unet2d", False, None),
    "scratch_unet": ("scratch_unet", False, _SCRATCH),
}


class _JaxRun(fnn.Module):
    """The JAX branch's tower call: ``run_tower`` on a tower named
    'tower'."""

    factory: Any
    remat: Any = False
    frozen: bool = False

    @fnn.compact
    def __call__(self, images, train):
        return jt.run_tower(self.factory(), images, train, remat=self.remat,
                            frozen=self.frozen, bf16=False)


class _TorchRun(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.tower = tower


def _images(n=3, size=(40, 24), seed=0):
    """``[n, W, H, 3]`` images, the last slot zero (a padding slot)."""
    x = np.random.default_rng(seed).normal(size=(n,) + size + (3,))
    x[-1] = 0.0
    return x.astype(np.float32)


def _pair(kind, images, seed=1):
    name, deep, cfg = _TOWERS[kind]
    factory, jc = jseg.make_tower(name, "batch", deep, tower_cfg=cfg)
    jrun = _JaxRun(factory)
    variables = jax_variables(jrun, images, False, seed=seed)
    tower, tc = tseg.make_tower(name, "batch", deep, device="cpu",
                                tower_cfg=cfg)
    assert tc == jc
    trun = _TorchRun(tower)
    load_flax_variables(trun, variables)
    return jrun, variables, trun


def _stats(trun):
    """The running statistics, copied (``to_flax_tree`` shares the CPU
    buffers' memory)."""
    return {k: v.copy() for k, v in
            flat_leaves(to_flax_tree(trun, "batch_stats")).items()}


def _jax_train(jrun, variables, images, **kw):
    run = _JaxRun(jrun.factory, **kw)
    y, new = jax.jit(lambda v, x: run.apply(v, x, True,
                                            mutable=["batch_stats"]))(
        variables, images)
    return np.asarray(y), flat_leaves(jax.device_get(new["batch_stats"]))


def _assert_stats(got, want, tol=2e-5):
    assert sorted(got) == sorted(want)
    bad = {k: rel_err(got[k], v) for k, v in want.items()
           if not rel_err(got[k], v) <= tol}
    assert not bad, bad


def _float64_train(trun, images):
    """The tower of ``trun`` (a copy) in training mode in float64, every
    conv in float64: ``(output [I, W, H, C], running statistics)``."""
    import copy

    import torch.nn.functional as F

    def conv(self, x):
        kh, kw = self.kernel_size
        w = self.weight
        if self.standardize:
            w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) * torch.rsqrt(
                w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
                * (kh * kw * w.shape[1]) + 1e-10)
        return F.conv2d(x, w, stride=self.strides, dilation=self.dilation,
                        padding=(kh // 2 * self.dilation[0],
                                 kw // 2 * self.dilation[1]))

    t64 = copy.deepcopy(trun).double().train()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tt.Conv2dWS, "forward", conv)
        y = t64.tower(torch.from_numpy(images).double().permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy(), _stats(t64)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", sorted(_TOWERS))
def test_batchnorm_tower_matches_jax(kind, train):
    images = _images()
    with jt.f32_convs(), tt.f32_convs():
        jrun, variables, trun = _pair(kind, images)
        before = _stats(trun)
        if train:
            y64, stats64 = _float64_train(trun, images)
        got = tt.run_tower(trun.tower, torch.from_numpy(images), train,
                           bf16=False).detach().numpy()
        if train:
            ref, ref_stats = _jax_train(jrun, variables, images)
        else:
            ref = np.asarray(jax.jit(lambda v, x: jrun.apply(v, x, False))(
                variables, images))
    assert got.shape == ref.shape and np.isfinite(got).all()
    stats = _stats(trun)
    assert any("BatchNorm_0" in k for k in stats)
    if train:
        assert rel_err(got, y64) <= 2e-5
        _assert_stats(stats, stats64, 2e-6)
        assert rel_err(got, ref) <= 1e-4
        _assert_stats(stats, ref_stats)
        assert all(not np.array_equal(stats[k], before[k]) for k in stats)
    else:
        assert rel_err(got, ref) <= 1e-5
        for k, v in before.items():
            np.testing.assert_array_equal(stats[k], v)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_layer_matches_flax(train):
    """flax ``nn.BatchNorm(momentum=0.9)`` (the JAX towers' norm) and the
    port's ``BatchNorm`` on the same maps, a zero image slot included:
    output and running statistics within 1e-6."""
    x = _images(4, (9, 7), seed=6)
    x = np.concatenate([x, 2.0 * x + 1.0], axis=-1)           # [4, 9, 7, 6]
    rng = np.random.default_rng(7)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6),
                            "bias": rng.normal(0.0, 0.2, 6)},
                 "batch_stats": {"mean": rng.normal(0.0, 0.3, 6),
                                 "var": rng.uniform(0.5, 2.0, 6)}}
    variables = jax.tree_util.tree_map(lambda v: v.astype(np.float32),
                                       variables)
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9)
    ref, new = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = tt.BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
        got = bn.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref)) <= 1e-6
    assert rel_err(bn.running_mean.numpy(),
                   np.asarray(new["batch_stats"]["mean"])) <= 1e-6
    assert rel_err(bn.running_var.numpy(),
                   np.asarray(new["batch_stats"]["var"])) <= 1e-6


@pytest.mark.parametrize("kind", ["resnet18_l4-deep", "resnet18_ppm-deep",
                                  "scratch_unet"])
def test_running_statistics_move_once_under_every_remat_mode(kind):
    """One training call with a backward pass under ``remat`` False, True
    and ``'convs'`` (whose recomputation runs every norm again): the same
    running statistics, bit for bit, as a single training forward without
    autograd, and JAX's ``nn.remat`` tower's within 2e-5; the input
    gradients agree across the modes."""
    images = _images(seed=2)
    cot = np.random.default_rng(3).normal(size=(1,)).astype(np.float32)
    with jt.f32_convs(), tt.f32_convs():
        jrun, variables, trun = _pair(kind, images, seed=2)
        state = {k: v.clone() for k, v in trun.state_dict().items()}
        with torch.no_grad():
            tt.run_tower(trun.tower, torch.from_numpy(images), True,
                         bf16=False)
        once = _stats(trun)
        grads = {}
        for remat in (False, True, "convs"):
            trun.load_state_dict(state)
            x = torch.from_numpy(images).requires_grad_()
            y = tt.run_tower(trun.tower, x, True, remat=remat, bf16=False)
            (y.sum() * float(cot[0])).backward()
            got = _stats(trun)
            for k, v in once.items():
                np.testing.assert_array_equal(got[k], v, err_msg=str(remat))
            grads[remat] = x.grad.numpy()
            _, ref_stats = _jax_train(jrun, variables, images, remat=remat)
            _assert_stats(got, ref_stats)
    assert rel_err(grads[True], grads[False]) <= 1e-6
    assert rel_err(grads["convs"], grads[False]) <= 1e-6


@pytest.mark.parametrize("kind", ["resnet18_l2", "resnet18_ppm-deep"])
def test_frozen_tower_uses_and_keeps_its_running_statistics(kind):
    """``frozen``: eval mode in training, as JAX's ``train and not frozen``:
    the output is JAX's frozen output within 1e-5, detached, and every
    parameter and running statistic stays bit for bit."""
    images = _images(seed=4)
    with jt.f32_convs(), tt.f32_convs():
        jrun, variables, trun = _pair(kind, images, seed=4)
        state = {k: v.clone() for k, v in trun.state_dict().items()}
        x = torch.from_numpy(images).requires_grad_()
        got = tt.run_tower(trun.tower, x, True, frozen=True, remat="convs",
                           bf16=False)
        ref, ref_stats = _jax_train(jrun, variables, images, frozen=True)
    assert not got.requires_grad
    assert rel_err(got.numpy(), ref) <= 1e-5
    for k, v in trun.state_dict().items():
        assert torch.equal(v, state[k]), k
    for k, v in flat_leaves(variables["batch_stats"]).items():
        np.testing.assert_array_equal(ref_stats[k], v)


def test_training_call_outside_run_tower_updates_its_own_statistics():
    bn = tt.BatchNorm(4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 4, 5, 2)).astype(np.float32))
    y = bn.train()(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(bn.running_mean, 0.1 * mean, atol=1e-7)
    assert torch.allclose(bn.running_var, 0.9 + 0.1 * var, atol=1e-6)
    want = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    assert torch.allclose(y, want, atol=1e-5)
    assert "num_batches_tracked" not in bn.state_dict()


def test_refnorm_takes_batchnorm():
    norm = ts._RefNorm(32, "batch")
    assert isinstance(norm.BatchNorm_0, tt.BatchNorm)
    assert norm.BatchNorm_0.epsilon == 1e-5
    with pytest.raises(ValueError):
        ts._RefNorm(32, "layer")


# --- crop-ladder batches -----------------------------------------------------

def _ladder_specs(**branch_kw):
    def build(flagship, branch_spec):
        spec = flagship(**TINY_SPEC)
        (_, b0), = spec.branches
        b0 = dataclasses.replace(b0, tower_bf16=False, **branch_kw)
        return dataclasses.replace(spec, branches=((0, b0),))

    return (build(jax_flagship_spec, jseg.BranchSpec),
            build(flagship_spec, tseg.BranchSpec))


def _ladder_models(seed=7, **branch_kw):
    batch, _, _ = jax_ladder_batch()
    jspec, tspec = _ladder_specs(**branch_kw)
    jmodel = jseg.MultimodalSeg(jspec)
    variables = jax_variables(jmodel, batch, seed=seed, train=False)
    tmodel = tseg.MultimodalSeg(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    return batch, jmodel, variables, tmodel


def test_ladder_buckets_update_the_running_statistics_in_order(monkeypatch):
    """A crop-ladder batch runs the tower once per bucket holding images
    (three here); each call moves the running statistics from where the one
    before left them, as flax's sequential ``batch_stats`` updates: the
    branch's statistics after one training forward within 2e-5 of JAX's,
    and not what the same calls in reverse order give."""
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _ladder_models(
        tower_norm="batch", tower_deep_stem=True)
    calls = []
    run_tower = tt.run_tower

    def recording(tower, images, *a, **k):
        calls.append(images)
        return run_tower(tower, images, *a, **k)

    from deepviewagg_tpu_torch.modules import multibucket as tmb

    monkeypatch.setattr(tmb, "run_tower", recording)
    with jt.f32_convs(), tt.f32_convs():
        _, new = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=True, mutable=["batch_stats"]))(variables, batch)
        tower = tmodel.branch_l0.tower
        start = {k: v.clone() for k, v in tower.state_dict().items()}
        tmodel.train()(torch_batch(batch))
    assert len(calls) == 3
    got = flat_leaves(to_flax_tree(tmodel, "batch_stats")["branch_l0"])
    want = flat_leaves(jax.device_get(new["batch_stats"]["branch_l0"]))
    _assert_stats(got, want)
    # the same calls in reverse bucket order end elsewhere
    tower.load_state_dict(start)
    with tt.f32_convs():
        for images in reversed(calls):
            tt.run_tower(tower, images, True, bf16=False)
    rev = flat_leaves({"tower": to_flax_tree(tower, "batch_stats")})
    worst = max(rel_err(rev[k], want[k]) for k in rev)
    assert worst > 1e-4


def test_ladder_tower_draws_its_channel_dropout_per_bucket(monkeypatch):
    """The crop-ladder path hands the step's generator to each bucket's
    tower call (a scratch tower whose last conv has an input channel
    dropout of 0.5, ``Dropout2d``: a mask per image): one mask per bucket
    call, drawn in bucket order, applied with the 1 / (1 - p) scaling.  The
    same masks imposed on the JAX model's ``dropout`` draws give the same
    training logits within 1e-4; without a generator nothing is dropped."""
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _ladder_models(
        seed=8, tower="scratch_unet", tower_cfg=_SCRATCH, out_channels=8)
    drop = tmodel.branch_l0.tower.last.drop
    assert drop.p == 0.5 and drop.per_image
    masks = []
    drop.register_forward_hook(lambda m, a, o: masks.append(
        None if m.mask is None else m.mask.clone()))
    tb = torch_batch(batch)
    with jt.f32_convs(), tt.f32_convs():
        tmodel.train()
        with torch.no_grad():
            plain = tmodel(tb)["logits"].numpy()
            assert masks == [None] * 3
            masks.clear()
            got = tmodel(tb, generator=torch.Generator().manual_seed(0))[
                "logits"].numpy()
        sizes = [len(b) for b in batch["bucket_images"] if len(b)]
        assert [tuple(m.shape) for m in masks] == [(n, 8, 1, 1)
                                                   for n in sizes]
        assert all(m.any() and not m.all() for m in masks)
        queue = [np.asarray(m.permute(0, 2, 3, 1).numpy()) for m in masks]

        def bernoulli(key, p, shape):
            keep = queue.pop(0)
            assert keep.shape == tuple(shape) and p == 0.5
            return keep

        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        ref = np.asarray(jmodel.apply(
            variables, batch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})[0]["logits"])
    assert not queue
    n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
    assert rel_err(got[:n], ref[:n]) <= 1e-4
    assert not np.allclose(got[:n], plain[:n])
