"""The bottleneck and squeeze-excitation Res16UNets of the PyTorch port
against the JAX package: each sparse block (``ResBlock``,
``BottleneckBlock``, ``SEResBlock``, ``SEBottleneckBlock``) and the
``SqueezeExcite`` gate alone, the preset nets' parameter counts at their
published widths, and narrow 3D-only nets of each block kind (whole-net
forward, one float32 train step).

Float32 operands (``f32_sparse_convs``), so the packages differ in summation
order only: a block's output, its input gradient, its parameter gradients
and its updated running statistics within 1e-5 of the largest magnitude, but
for the squeeze-excitation gate's parameter gradients, held to 1e-4 (the
bound of ``test_torch_port_scratch2d.py`` for parameter gradients): the
gradient reaching the gate's hidden layer is a 32-term dot product through
the sigmoid that cancels, and on the ``SEBottleneckBlock`` case the port's
float32 ``Dense_0`` bias gradient lies 2.7e-5 from a float64 evaluation of
the same block (JAX's 2.6e-6; the gate's own cotangent agrees with float64
to 8e-7 in both);
whole nets' logits within 1e-4, the train step's loss within 1e-5 and its
gradient leaves within 1e-4 (the bounds of ``test_torch_port_model.py`` and
``test_torch_port_train_step.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.models import losses as jlosses
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.nn import sparse_blocks as jb
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.nn import res16unet as tres
from deepviewagg_tpu_torch.nn import sparse_blocks as tb
from deepviewagg_tpu_torch.ops import segment as tsegops
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             flat_leaves, jax_tiny_batch, jax_variables,
                             rel_err, torch_batch)

_BLOCKS = {"basic": (jb.ResBlock, tb.ResBlock),
           "bottleneck": (jb.BottleneckBlock, tb.BottleneckBlock),
           "se_basic": (jb.SEResBlock, tb.SEResBlock),
           "se_bottleneck": (jb.SEBottleneckBlock, tb.SEBottleneckBlock)}


def _level(i=1):
    """Level ``i`` of the tiny batch's graph (two samples, padding rows)."""
    return jax_tiny_batch()[0]["graph"]["levels"][i]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _block_run(kind, cin, cout, train, seed=3):
    """One block of both packages from the same variables on level 1:
    outputs, the input and parameter gradients of ``sum(out * cot)`` and the
    running statistics after the call."""
    jcls, tcls = _BLOCKS[kind]
    lvl = _level()
    nbr, valid, bidx = lvl["sub_nbr"], lvl["valid"], lvl["batch_idx"]
    feats = _rand((len(valid), cin), seed)
    jmod = jcls(cout)
    variables = jax_variables(jmod, feats, nbr, valid, train=False,
                              batch_idx=bidx, seed=seed)
    cot = _rand((len(valid), cout), seed + 1)

    def loss(params, x):
        out, new = jmod.apply(dict(variables, params=params), x, nbr, valid,
                              train=train, batch_idx=bidx,
                              mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new)

    (_, (ref, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], feats)

    tmod = tcls(cin, cout)
    load_flax_variables(tmod, variables)
    tmod.train(train)
    x = torch.from_numpy(feats).requires_grad_()
    got = tmod(x, torch.from_numpy(nbr), torch.from_numpy(valid),
               torch.from_numpy(bidx))
    (got * torch.from_numpy(cot)).sum().backward()
    return {"ref": np.asarray(ref), "got": got.detach().numpy(),
            "ref_gx": np.asarray(gx), "got_gx": x.grad.numpy(),
            "ref_gp": flat_leaves(jax.device_get(gp)),
            "got_gp": flat_leaves(to_flax_tree(tmod, "grads")),
            "ref_stats": flat_leaves(jax.device_get(new["batch_stats"])),
            "got_stats": flat_leaves(to_flax_tree(tmod, "batch_stats"))}


def _assert_leaves(got, want, tol):
    assert sorted(got) == sorted(want)
    bad = {k: rel_err(got[k], v) for k, v in want.items()
           if not rel_err(got[k], v) <= tol}
    assert not bad, bad


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32)],
                         ids=["project", "identity"])
@pytest.mark.parametrize("kind", sorted(_BLOCKS))
def test_block_matches_jax(monkeypatch, kind, cin, cout, train):
    f32_sparse_convs(monkeypatch)
    out = _block_run(kind, cin, cout, train)
    assert out["got"].shape == out["ref"].shape == (len(_level()["valid"]),
                                                    cout)
    assert rel_err(out["got"], out["ref"]) <= 1e-5
    assert rel_err(out["got_gx"], out["ref_gx"]) <= 1e-5
    gate = {k for k in out["ref_gp"] if k.startswith("SqueezeExcite_0/")}
    _assert_leaves({k: v for k, v in out["got_gp"].items() if k not in gate},
                   {k: v for k, v in out["ref_gp"].items() if k not in gate},
                   1e-5)
    _assert_leaves({k: out["got_gp"][k] for k in gate},
                   {k: out["ref_gp"][k] for k in gate}, 1e-4)
    _assert_leaves(out["got_stats"], out["ref_stats"], 1e-5)
    names = {k.split("/")[0] for k in out["ref_gp"]}
    if kind.startswith("se"):
        assert "SqueezeExcite_0" in names
    if kind.endswith("bottleneck"):
        assert {"Dense_0", "Dense_1"} <= names
    skip = "Dense_2" if kind.endswith("bottleneck") else "Dense_0"
    assert (skip in names) == (cin != cout)


def test_squeeze_excite_gates_each_sample_and_launches_two_reductions():
    """The gate of each row is its sample's: the mean over the sample's valid
    rows, padding rows in the last of 33 segments.  Two sorted-segment
    reductions forward (the sum and the count) and one backward."""
    lvl = _level()
    valid, bidx = lvl["valid"], lvl["batch_idx"]
    x = _rand((len(valid), 32), 5)
    jmod = jb.SqueezeExcite()
    variables = jax_variables(jmod, x, bidx, valid, seed=5)
    ref = np.asarray(jmod.apply(variables, x, bidx, valid))
    tmod = tb.SqueezeExcite(32)
    load_flax_variables(tmod, variables)
    calls = []
    original = tsegops.segment_csr

    def recording(xs, ptr, v, reduce):
        calls.append((tuple(xs.shape), len(ptr) - 1, reduce))
        return original(xs, ptr, v, reduce)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsegops, "segment_csr", recording)
        xt = torch.from_numpy(x).requires_grad_()
        got = tmod(xt, torch.from_numpy(bidx), torch.from_numpy(valid))
    assert rel_err(got.detach().numpy(), ref) <= 1e-5
    assert calls == [((len(valid), 32), 33, "sum"),
                     ((len(valid), 1), 33, "sum")]
    # the gate is constant over a sample's rows: x * gate
    gate = (got.detach() / xt.detach()).numpy()
    for b in np.unique(bidx[valid]):
        rows = gate[(bidx == b) & valid & (np.abs(x).min(1) > 1e-3)]
        assert np.ptp(rows, axis=0).max() <= 1e-5


_PRESETS = ("Res16UNet50", "Res16UNet101", "SERes16UNet34", "SERes16UNet50")


@pytest.mark.parametrize("name", _PRESETS)
def test_preset_parameter_count_matches_jax(name):
    """At 13 classes, as ``jax.eval_shape`` builds the flax net on the tiny
    batch: every parameter under the same name with the same shape."""
    from deepviewagg_tpu.config import zoo as jzoo
    from deepviewagg_tpu_torch.config import zoo as tzoo

    batch, _ = jax_tiny_batch()
    spec = jzoo.get_model_spec(name, 13, 4)
    shapes = jax.eval_shape(lambda: jseg.build_model(spec).init(
        jax.random.PRNGKey(0), batch, train=False))
    want = {k: tuple(v.shape) for k, v in flat_leaves(shapes["params"]).items()}
    model = tseg.build_model(tzoo.get_model_spec(name, 13, 4), device="cpu",
                             seed=None)
    got = {k: v.shape for k, v in flat_leaves(to_flax_tree(model)).items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in want.values())


_NARROW = dict(backbone_layers=(2, 1, 1, 1, 1, 1, 1, 2),
               backbone_planes=(16, 16, 32, 32, 32, 16, 16, 16))


def _narrow_specs(block):
    kw = dict(num_classes=4, backbone="Res16UNetTest", backbone_block=block,
              **_NARROW)
    return jseg.ModelSpec(**kw), tseg.ModelSpec(**kw)


def _narrow_models(block, seed=4):
    batch, _ = jax_tiny_batch()
    jspec, tspec = _narrow_specs(block)
    jmodel = jseg.build_model(jspec)
    variables = jax_variables(jmodel, batch, seed=seed, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    return batch, jmodel, variables, tmodel


@pytest.mark.parametrize("block", sorted(_BLOCKS))
def test_narrow_net_forward_matches_jax(monkeypatch, block):
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _narrow_models(block)
    names = {k.split(".")[2] for k, _ in tmodel.named_modules()
             if k.startswith("backbone.DownStage_0.")}
    assert f"{tres._BLOCKS[block].__name__}_1" in names
    ref = np.asarray(jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, batch)["logits"])
    with torch.no_grad():
        got = tmodel.eval()(torch_batch(batch))["logits"].numpy()
    n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
    assert np.isfinite(got).all()
    assert rel_err(got[:n], ref[:n]) <= 1e-4


_OPT = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=10.0)


@pytest.mark.parametrize("block", sorted(_BLOCKS))
def test_narrow_net_train_step_matches_jax(monkeypatch, block):
    """One float32 train step of ``make_train_step`` in both packages: the
    loss within 1e-5, the gradient norm and every gradient leaf within 1e-4,
    the running statistics after the step within 1e-5; the SE nets launch
    the sorted-segment reductions their blocks hold (2 forward, 1 backward
    each) on top of none."""
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _narrow_models(block, seed=5)
    valid = jnp.asarray(batch["graph"]["levels"][0]["valid"])
    labels = jnp.asarray(batch["labels"])

    def loss_fn(params):
        out, new = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return jlosses.segmentation_loss(out["logits"], labels, valid), new

    (ref_loss, new), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tx = jopt.make_optimizer(jopt.make_schedule("constant", 0.1), **_OPT)
    state = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    _, ref_m = jax.jit(jstep.make_train_step(jmodel))(
        state, batch, jax.random.PRNGKey(0))

    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = tsegops.segment_csr_plain, \
        tsegops.segment_csr_bwd_plain

    def fwd(*a, **k):
        calls["fwd"] += 1
        return plain_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return plain_bwd(*a, **k)

    monkeypatch.setattr(tsegops, "segment_csr_plain", fwd)
    monkeypatch.setattr(tsegops, "segment_csr_bwd_plain", bwd)
    tstate = tstep.TrainState.create(tmodel, topt.make_optimizer(
        topt.make_schedule("constant", 0.1), **_OPT))
    _, got_m = tstep.make_train_step(tmodel)(tstate, torch_batch(batch),
                                             None)
    assert abs(float(got_m["loss"]) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    assert abs(float(ref_m["loss"]) - float(ref_loss)) <= 1e-6 * abs(
        float(ref_loss))
    assert abs(float(got_m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
        1e-4 * float(ref_m["grad_norm"])
    _assert_leaves(flat_leaves(to_flax_tree(tmodel, "grads")),
                   flat_leaves(jax.device_get(ref_grads)), 1e-4)
    _assert_leaves(flat_leaves(to_flax_tree(tmodel, "batch_stats")),
                   flat_leaves(jax.device_get(new["batch_stats"])), 1e-5)
    n_se = sum(_NARROW["backbone_layers"]) if block.startswith("se") else 0
    assert calls == {"fwd": 2 * n_se, "bwd": n_se}


def test_se_blocks_need_the_batch_index():
    lvl = _level()
    block = tb.SEResBlock(8, 8)
    with pytest.raises(ValueError, match="batch_idx"):
        block(torch.zeros(len(lvl["valid"]), 8),
              torch.from_numpy(lvl["sub_nbr"]), torch.from_numpy(lvl["valid"]))
    assert dataclasses.asdict(_narrow_specs("se_basic")[1])["backbone_block"] \
        == "se_basic"
