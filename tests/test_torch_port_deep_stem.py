"""The S3DIS recipe's model in the PyTorch port against the JAX package: the
MIT-semseg deep stem of ``ResNet18`` (three 3x3 conv + norm + relu of 64,
64 and 128 channels in place of the 7x7), ``make_tower`` / ``build_model``,
a ``MultimodalSeg`` over a deep-stem ``resnet18_l4`` branch and the 3D-only
``SparseConv3dSeg``.

Float32 operands throughout (``f32_convs``, ``f32_sparse_convs``), so the
two frameworks differ in summation order only: the tower's output and its
input gradient within 1e-5 of the largest magnitude, whole models' logits
within 1e-4 (the bound of ``test_torch_port_model.py``).  The JAX side
runs under ``jax.jit`` (eager flax takes several times longer on the CPU).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             flat_leaves, jax_tiny_batch, jax_variables,
                             rel_err, torch_batch)

RECIPE = "Res16UNet34-L4-early-ade20k-interpolate"


class _JaxRun(fnn.Module):
    """The JAX branch's tower call: ``run_tower`` on a tower named 'tower'."""

    out_level: int

    @fnn.compact
    def __call__(self, images):
        return jt.run_tower(
            jt.ResNet18(out_level=self.out_level, deep_stem=True,
                        name="tower"), images, False, remat=False, bf16=False)


class _TorchRun(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.tower = tower


@pytest.mark.parametrize("out_level", [0, 4])
def test_deep_stem_tower_matches_jax(out_level):
    # an image whose stem max-pool windows route the gradient alike in both
    # frameworks: where a window's two largest elements lie within float32
    # noise of each other, either may take the window's gradient (both
    # right); image seeds 3 and 4 have such a window, and the input gradient
    # at out_level 4 then differs by 7e-3 in the patch below it
    images = np.random.default_rng(0).normal(
        size=(2, 64, 32, 3)).astype(np.float32)
    jrun = _JaxRun(out_level)
    variables = jax_variables(jrun, images, seed=5)
    tower = tt.ResNet18(out_level=out_level, deep_stem=True, device="cpu")
    load_flax_variables(_TorchRun(tower), variables)
    with jt.f32_convs():
        ref = jax.jit(jrun.apply)(variables, images)
        cot = np.random.default_rng(9).normal(size=ref.shape).astype(np.float32)
        ref_grad = jax.jit(lambda x, c: jax.vjp(
            lambda y: jrun.apply(variables, y), x)[1](c)[0])(images, cot)
    x = torch.from_numpy(images).requires_grad_()
    with tt.f32_convs():
        got = tt.run_tower(tower, x, bf16=False)
    got.backward(torch.from_numpy(cot))
    assert got.shape == ref.shape
    assert got.shape[-1] == (128 if out_level == 0 else 512)
    assert rel_err(got.detach().numpy(), ref) <= 1e-5
    assert rel_err(x.grad.numpy(), ref_grad) <= 1e-5


def test_deep_stem_names_and_shortcut_match_flax():
    """Stem ``Conv2dWS_0..2`` / ``_Norm_0..2`` and the blocks' indices are
    flax's; layer1's first block projects its shortcut (128 -> 64) exactly
    when the flax block does, and layer1's second block does not."""
    images = np.zeros((1, 32, 16, 3), np.float32)
    variables = jax_variables(_JaxRun(1), images)
    params = variables["params"]["tower"]
    tower = tt.ResNet18(out_level=1, deep_stem=True, device="cpu")
    load_flax_variables(_TorchRun(tower), variables)       # strict, by name
    assert {k for k in params if k.startswith(("Conv2dWS", "_Norm"))} == {
        "Conv2dWS_0", "Conv2dWS_1", "Conv2dWS_2", "_Norm_0", "_Norm_1",
        "_Norm_2"}
    assert [tuple(getattr(tower, f"Conv2dWS_{i}").weight.shape)
            for i in range(3)] == [(64, 3, 3, 3), (64, 64, 3, 3),
                                   (128, 64, 3, 3)]
    for i, projects in ((0, True), (1, False)):
        assert ("Conv2dWS_2" in params[f"_BasicBlock2d_{i}"]) is projects
        block = getattr(tower, f"_BasicBlock2d_{i}")
        assert (block.Conv2dWS_2 is not None) is projects
    assert tuple(tower._BasicBlock2d_0.Conv2dWS_2.weight.shape) == (64, 128, 1, 1)


@pytest.mark.parametrize("name,channels", [
    ("resnet18_l0", 128), ("resnet18_l1", 64), ("resnet18_l4", 512),
    ("resnet18_ppm", 128)])
def test_make_tower_with_the_deep_stem(name, channels):
    _, jc = jseg.make_tower(name, "group", True)
    tower, tc = tseg.make_tower(name, "group", True, device="cpu")
    assert tc == jc == channels
    stem = tower.ResNet18_0 if name == "resnet18_ppm" else tower
    assert stem.num_stem == 3
    # the BatchNorm tower (pretrained weights): plain convs, flax
    # ``BatchNorm_0`` leaves, the JAX tree leaf for leaf
    fac, jc = jseg.make_tower(name, "batch", True)
    tower, tc = tseg.make_tower(name, "batch", True, device="cpu")
    assert tc == jc == channels
    shapes = jax.eval_shape(lambda: fac(parent=None).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 24, 3), np.float32), False))
    want = {k: tuple(v.shape) for k, v in flat_leaves(shapes).items()}
    got = {k: tuple(v.shape) for c in ("params", "batch_stats")
           for k, v in flat_leaves({c: to_flax_tree(tower, c)}).items()}
    assert got == want
    assert any("/BatchNorm_0/" in k for k in want)
    assert not any(m.standardize for m in tower.modules()
                   if isinstance(m, tt.Conv2dWS))


def _tiny_specs(name, **overrides):
    kw = dict(backbone="Res16UNetTest", tower_bf16=False, **overrides)
    return (jzoo.get_model_spec(name, 4, 4, kw),
            tzoo.get_model_spec(name, 4, 4, kw))


def _model_parity(jspec, tspec, train: bool):
    batch, _ = jax_tiny_batch()
    jmodel = jseg.build_model(jspec)
    variables = jax_variables(jmodel, batch, seed=2, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    tmodel.train(train)
    with jt.f32_convs(), tt.f32_convs():
        out = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=train, mutable=["batch_stats"] if train else False))(
                variables, batch)
        ref = np.asarray((out[0] if train else out)["logits"])
        with torch.no_grad():
            got = tmodel(torch_batch(batch))["logits"].numpy()
    n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
    return got[:n], ref[:n]


def test_multimodal_seg_over_a_deep_stem_l4_branch_matches_jax(monkeypatch):
    """Eval mode; in training mode the masked batch norms' statistics over
    the few voxels of the tiny batch's deep levels amplify float32 noise to
    3e-4 (the whole train step is held in ``test_torch_port_trainer.py``)."""
    f32_sparse_convs(monkeypatch)
    # the recipe's branch (512-d deep-stem L4 tower, group-4 pool, concat
    # before the stem) over the tiny test backbone
    jspec, tspec = _tiny_specs(RECIPE)
    (_, b), = tspec.branches
    assert b.tower == "resnet18_l4" and b.tower_deep_stem
    assert b.out_channels == 512 and b.num_groups == 4
    got, ref = _model_parity(jspec, tspec, train=False)
    assert rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sparse_conv3d_seg_matches_jax(monkeypatch, train):
    f32_sparse_convs(monkeypatch)
    jspec, tspec = _tiny_specs("Res16UNet14")
    assert not tspec.branches
    assert isinstance(tseg.build_model(tspec, device="cpu"),
                      tseg.SparseConv3dSeg)
    got, ref = _model_parity(jspec, tspec, train)
    assert rel_err(got, ref) <= 1e-4


def test_recipe_model_builds_at_published_width():
    """``Res16UNet34-L4-early-ade20k-interpolate`` with the S3DIS recipe's
    13 classes: the same parameter tree and count as the flax model."""
    batch, _ = jax_tiny_batch()
    spec = jzoo.get_model_spec(RECIPE, 13, 4)
    shapes = jax.eval_shape(lambda: jseg.build_model(spec).init(
        jax.random.PRNGKey(0), batch, train=False))
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = tseg.build_model(tzoo.get_model_spec(RECIPE, 13, 4), device="cpu")
    got = sum(p.numel() for p in model.parameters())
    assert got == want > 40_000_000
    assert model.branch_l0.tower.num_stem == 3


@pytest.mark.parametrize("name", ["No3D-L4-max", "Res16UNet34-LateLogitFusion",
                                  "Res16UNet34-LateFeatureFusion"])
def test_build_model_refuses_unported_families(name):
    """The families these cases once refused build now, with the JAX
    package's parameter count at the S3DIS recipe's 13 classes."""
    batch, _ = jax_tiny_batch()
    spec = jzoo.get_model_spec(name, 13, 4)
    shapes = jax.eval_shape(lambda: jseg.build_model(spec).init(
        jax.random.PRNGKey(0), batch, train=False))
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = tseg.build_model(tzoo.get_model_spec(name, 13, 4), device="meta",
                             seed=None)
    assert type(model).__name__ == type(jseg.build_model(spec)).__name__
    assert sum(p.numel() for p in model.parameters()) == want


def test_multimodal_seg_takes_specs_of_either_stem():
    _, tspec = _tiny_specs("Res16UNet14-L1-early-group2-interpolate")
    stems = {}
    for deep in (False, True):
        spec = dataclasses.replace(tspec, branches=tuple(
            (lvl, dataclasses.replace(b, tower_deep_stem=deep))
            for lvl, b in tspec.branches))
        model = tseg.build_model(spec, device="cpu")
        stems[deep] = model.branch_l0.tower.num_stem
    assert stems == {False: 1, True: 3}
