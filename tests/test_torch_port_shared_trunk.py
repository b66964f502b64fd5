"""The three branch kinds that only reference ingest builds, in the PyTorch
port against the JAX package: the Res16Image shared trunk
(``ConvDown2D``, run once a forward, its taps gathered at successive
levels), single-tower reuse (XYZ-RGB-L4-all: one ``reuse_tower`` feeding
the branch that declares it and every ``"reuse"`` one) and the tower-less
raw-RGB branch (``ModalityIdentity``), on flat batches, and the tower-less
branch on a crop-ladder batch, which shared and reuse refuse.  The models
are the ingested fixture entries (``torch_port_refconf.py``) on the
``Res16UNetTest`` backbone with 64 x 32 images.

Float32 operands throughout (``f32_sparse_convs``, ``f32_convs``, float32
tower activations): logits within 1e-4 of the largest magnitude, the train
step's loss within 1e-5 and its gradient leaves within 1e-4, as
``test_torch_port_families.py`` holds the other families.  ``ConvDown2D``'s
taps within 1e-5.  Then ``cli.train`` + ``cli.eval`` on the CPU with
``model.name=ref:...`` and ``data.ref=...`` on a miniature S3DIS layout."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.config import reference_ingest as jri
from deepviewagg_tpu.data.toy import toy_batch
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.models.losses import segmentation_loss as jax_seg_loss
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import reference_ingest as tri
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_refconf import write_reference_conf
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             fake_s3dis_layout, flat_leaves, jax_ladder_batch,
                             jax_variables, rel_err, torch_batch)

SPARSE = "models/segmentation/multimodal/sparseconv3d.yaml"
KINDS = {"shared": "Res16UNet14-Res16Image-max",
         "reuse": "Res16UNet14-L4-all",
         "raw": "Res16UNet14-RGB-identity-early"}


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    return write_reference_conf(tmp_path_factory.mktemp("ref"))


@functools.lru_cache(maxsize=None)
def flat_batch():
    """A tiny flat batch with mappings at every level of Res16UNetTest."""
    batch, _, _ = toy_batch(n_samples=1, density=25.0, image_size=(64, 32),
                            n_cameras=1, branch_levels=(0, 1, 2, 3, 4))
    return {k: v for k, v in batch.items() if k != "meta"}


def _test_size(spec):
    return dataclasses.replace(spec, backbone="Res16UNetTest", branches=tuple(
        (lvl, dataclasses.replace(b, tower_bf16=False))
        for lvl, b in spec.branches))


def _specs(conf, kind):
    path = str(conf / SPARSE)
    return (_test_size(jri.load_model_spec(path, KINDS[kind], 4)),
            _test_size(tri.load_model_spec(path, KINDS[kind], 4)))


def _models(conf, kind, batch, seed=5):
    jspec, tspec = _specs(conf, kind)
    jmodel = jseg.build_model(jspec)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax_variables(jmodel, jb, seed=seed, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    return jmodel, jb, variables, tmodel


# --- ConvDown2D and run_tower over its taps -----------------------------------

PLANS = {"published": ((32, 32, 64, 128, 256), (0, 2, 2, 2, 2),
                       (1, 2, 2, 2, 2)),
         "narrow": ((8, 16, 16), (1, 0, 2), (2, 1, 2))}


def _images(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 64, 32, 3)).astype(np.float32)


def _convdown(plan):
    widths, blocks, strides = PLANS[plan]
    jmod = jt.ConvDown2D(widths=widths, blocks=blocks, strides=strides)
    images = _images()
    variables = jax_variables(jmod, jnp.asarray(images), train=True)
    tmod = tt.ConvDown2D(widths, blocks, strides, device="cpu")
    load_flax_variables(tmod, variables)
    return jmod, variables, tmod, images


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_convdown2d_taps_match_jax(plan):
    """Each stage's tap of ``run_tower`` over the trunk, float32 operands:
    within 1e-5 of the JAX one, at the stage's stride."""
    jmod, variables, tmod, images = _convdown(plan)
    assert sorted(flat_leaves(to_flax_tree(tmod))) == sorted(
        flat_leaves(variables["params"]))
    with jt.f32_convs(), tt.f32_convs():
        ref = jt.run_tower(lambda x, train: jmod.apply(variables, x, train),
                           jnp.asarray(images), True, bf16=False)
        got = tt.run_tower(tmod, torch.from_numpy(images), True, bf16=False)
    assert isinstance(got, tuple) and len(got) == len(ref) == len(
        PLANS[plan][0])
    w, h = 64, 32
    for t, r, width, s in zip(got, ref, PLANS[plan][0], PLANS[plan][2]):
        w, h = -(-w // s), -(-h // s)
        assert t.shape == (2, w, h, width) == r.shape
        assert rel_err(t.detach().numpy(), np.asarray(r)) <= 1e-5


@pytest.mark.parametrize("bf16,out_f32", [(False, True), (True, True),
                                          (True, False)])
def test_run_tower_casts_every_tap(bf16, out_f32):
    """bf16 activations and the float32 output apply to each tap, as the
    JAX ``run_tower`` maps them over the tuple."""
    _, _, tmod, images = _convdown("narrow")
    taps = tt.run_tower(tmod, torch.from_numpy(images), False, bf16=bf16,
                        out_f32=out_f32)
    want = torch.float32 if out_f32 or not bf16 else torch.bfloat16
    assert [t.dtype for t in taps] == [want] * 3
    assert all(t.is_contiguous() for t in taps)


def test_run_tower_tuple_under_remat_and_frozen():
    """Under ``remat`` False, True and ``'convs'`` the taps and every
    parameter's gradient are equal, and each tap alone carries gradient
    back to the first stage; ``frozen`` gives detached taps, equal in
    value, in eval mode."""
    _, _, tmod, images = _convdown("narrow")
    x = torch.from_numpy(images)
    rng = np.random.default_rng(3)
    cots = [torch.from_numpy(rng.normal(size=(2,) + shape).astype(np.float32))
            for shape in ((32, 16, 8), (32, 16, 16), (16, 8, 16))]
    params = list(tmod.parameters())
    results = {}
    with tt.f32_convs():
        for remat in (False, True, "convs"):
            taps = tt.run_tower(tmod, x, True, remat=remat, bf16=False)
            grads = torch.autograd.grad(
                sum((t * c).sum() for t, c in zip(taps, cots)), params)
            results[remat] = ([t.detach() for t in taps], grads)
            for i, c in enumerate(cots):
                tap = tt.run_tower(tmod, x, True, remat=remat, bf16=False)[i]
                g, = torch.autograd.grad((tap * c).sum(),
                                         tmod.stage0_conv.weight)
                assert float(g.abs().max()) > 0, (remat, i)
        base_taps, base_grads = results[False]
        for remat in (True, "convs"):
            taps, grads = results[remat]
            for a, b in zip(base_taps, taps):
                assert torch.equal(a, b)
            for a, b in zip(base_grads, grads):
                assert rel_err(b.numpy(), a.numpy()) <= 1e-6
        frozen = tt.run_tower(tmod, x, True, frozen=True, bf16=False)
        plain = tt.run_tower(tmod, x, False, bf16=False)
    assert all(not t.requires_grad for t in frozen)
    for a, b in zip(frozen, plain):
        assert torch.equal(a, b)


# --- the three branch kinds against the JAX models ----------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_forward_matches_jax(monkeypatch, conf, kind):
    f32_sparse_convs(monkeypatch)
    batch = flat_batch()
    jmodel, jb, variables, tmodel = _models(conf, kind, batch)
    with jt.f32_convs(), tt.f32_convs():
        ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jb)
        with torch.no_grad():
            got = tmodel.eval()(torch_batch(batch))
    n = int(batch["graph"]["levels"][0]["valid"].sum())
    assert rel_err(got["logits"].numpy()[:n],
                   np.asarray(ref["logits"])[:n]) <= 1e-4
    np.testing.assert_array_equal(got["x_seen"].numpy(),
                                  np.asarray(ref["x_seen"]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_parameter_tree_matches_jax(conf, kind):
    """The flax scopes: ``shared_tower/stage{i}_conv`` ... or
    ``reuse_tower/...`` at the top, no ``tower`` under a tower-less or fed
    branch; equal parameter counts, at test size and at the entries' own
    backbones."""
    batch = flat_batch()
    jmodel, _, variables, tmodel = _models(conf, kind, batch)
    names = flat_leaves(to_flax_tree(tmodel))
    assert sorted(names) == sorted(flat_leaves(variables["params"]))
    paths = [k.split("/") for k in names]
    tops = {p[0] for p in paths}
    assert ("shared_tower" in tops) == (kind == "shared")
    assert ("reuse_tower" in tops) == (kind == "reuse")
    assert not any(p[0].startswith("branch") and p[1] == "tower"
                   for p in paths)
    if kind == "shared":
        assert "shared_tower/stage1_block1/Conv2dWS_0/kernel" in names
        assert "shared_tower/stage0_norm/GroupNorm_0/scale" in names
    path = str(conf / SPARSE)
    jspec = jri.load_model_spec(path, KINDS[kind], 13)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda: jseg.build_model(jspec).init(
        jax.random.PRNGKey(0), jb, train=False))
    want = sum(int(np.prod(v.shape))
               for v in flat_leaves(shapes["params"]).values())
    model = tseg.build_model(tri.load_model_spec(path, KINDS[kind], 13),
                             device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == want


def _jax_loss_and_grads(jmodel, variables, jb):
    valid = jb["graph"]["levels"][0]["valid"]

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params,
                               "batch_stats": variables.get("batch_stats",
                                                            {})},
                              jb, train=True, mutable=["batch_stats"])
        return jax_seg_loss(out["logits"], jb["labels"], valid)

    return jax.jit(jax.value_and_grad(loss_fn))(variables["params"])


def _step_spec(spec):
    """The train step's variant of a test-size spec: the nearest pixel
    gather, so that the atomic max meets only exact ties (which both
    packages route alike), and max view pools in place of the reuse
    entry's group pools: behind a group pool the JAX package's float32
    gradient of the tower carries 0.3-0.5% of noise (as the late models'
    does, ``test_torch_port_families.py``), which
    ``test_reuse_tower_gets_gradient_through_every_level`` holds against
    the port's own float64 gradient instead."""
    reuse = any(b.tower == "reuse" for _, b in spec.branches)
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, interpolate=False, view_pool="max"
                                  if reuse else b.view_pool))
        for lvl, b in spec.branches))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_train_step_matches_jax(monkeypatch, conf, kind):
    """One float32 train step through the port's ``make_train_step``: loss
    within 1e-5, every gradient leaf within 1e-4 (the shared trunk's and
    the reused tower's included); see ``_step_spec``."""
    f32_sparse_convs(monkeypatch)
    batch = flat_batch()
    jspec, tspec = (_step_spec(s) for s in _specs(conf, kind))
    jmodel = jseg.build_model(jspec)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax_variables(jmodel, jb, seed=6, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    with jt.f32_convs(), tt.f32_convs():
        ref_loss, ref_grads = _jax_loss_and_grads(jmodel, variables, jb)
        state = tstep.TrainState.create(tmodel, topt.make_optimizer(
            topt.make_schedule("constant", 0.1), grad_clip=10.0))
        _, metrics = tstep.make_train_step(tmodel)(state, torch_batch(batch),
                                                   None)
    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    grads = flat_leaves(to_flax_tree(tmodel, "grads"))
    ref = flat_leaves(jax.device_get(ref_grads))
    assert sorted(grads) == sorted(ref)
    bad = {k: rel_err(grads[k], ref[k]) for k in ref
           if not rel_err(grads[k], ref[k]) <= 1e-4}
    assert not bad, bad
    trunk = {"shared": "shared_tower/", "reuse": "reuse_tower/"}.get(kind)
    if trunk:
        assert max(float(np.abs(v).max()) for k, v in grads.items()
                   if k.startswith(trunk)) > 0


def test_reuse_tower_gets_gradient_through_every_level(conf):
    """The reuse entry as written (group pools, bilinear gather): the reused
    tower's maps reach the loss through each of the three branches (levels
    0, 1 and 3), as the JAX test of tower reuse checks for the tower as a
    whole, and the tower's parameter gradients equal a float64 evaluation
    of the same tower for the cotangent its maps got (1e-5)."""
    import copy

    from test_torch_port_families import _f64_tower_grads

    batch = flat_batch()
    _, _, _, tmodel = _models(conf, "reuse", batch)
    tower_before = copy.deepcopy(tmodel.reuse_tower)
    seen = {}

    def tap(name):
        def pre(module, args):
            maps = args[1].view_as(args[1])
            maps.register_hook(
                lambda g: seen.__setitem__(name, float(g.abs().max())))
            return (args[0], maps) + args[2:]
        return pre

    def keep_cot(module, args, out):
        if "cot" not in seen:
            seen["cot"] = None
            out.register_hook(lambda g: seen.__setitem__(
                "cot", g.permute(0, 2, 3, 1)))

    for name in ("branch_l0", "branch_l1", "branch_l3"):
        getattr(tmodel, name).register_forward_pre_hook(tap(name))
    tmodel.reuse_tower.register_forward_hook(keep_cot)
    tb = torch_batch(batch)
    valid = tb["graph"]["levels"][0]["valid"]
    with tt.f32_convs():
        out = tmodel.train()(tb)
        loss = torch.nn.functional.cross_entropy(
            out["logits"][valid], tb["labels"][valid].long())
        loss.backward()
    assert all(seen[n] > 0 for n in ("branch_l0", "branch_l1", "branch_l3"))
    grads = flat_leaves(to_flax_tree(tmodel, "grads"))
    f64 = _f64_tower_grads(tower_before, tb["images"], seen["cot"])
    assert len(f64) == len([k for k in grads if k.startswith("reuse_tower/")])
    bad = {k: rel_err(grads["reuse_tower/" + k], v) for k, v in f64.items()
           if not rel_err(grads["reuse_tower/" + k], v) <= 1e-5}
    assert not bad, bad


# --- crop-ladder batches -----------------------------------------------------

def _ladder_spec(pkg, kind):
    b = dict(out_channels=16, view_pool="max", fusion_mode="concat",
             tower_bf16=False)
    if kind == "raw":
        branches = ((0, pkg.BranchSpec(tower=None, **b)),
                    (1, pkg.BranchSpec(tower=None, **dict(
                        b, view_pool="mean", fusion_mode="residual"))))
        return pkg.ModelSpec(num_classes=4, backbone="Res16UNetTest",
                             branches=branches)
    if kind == "shared":
        return pkg.ModelSpec(
            num_classes=4, backbone="Res16UNetTest",
            shared_tower=((8, 16), (0, 1), (1, 2)),
            branches=((0, pkg.BranchSpec(tower="shared:0", **b)),
                      (1, pkg.BranchSpec(tower="shared:1", **b))))
    return pkg.ModelSpec(
        num_classes=4, backbone="Res16UNetTest",
        branches=((0, pkg.BranchSpec(tower="resnet18_l1", **b)),
                  (1, pkg.BranchSpec(tower="reuse", **b))))


def test_tower_less_branch_on_a_ladder_batch_matches_jax(monkeypatch):
    """Raw-RGB branches at levels 0 and 1 (a max and a mean view pool)
    on the crop-ladder batch: each bucket's images gathered as they are;
    logits within 1e-4, the step's loss within 1e-5 and its gradient
    leaves within 1e-4.  (A group pool on a ladder batch carries the JAX
    package's float32 noise of ``test_torch_port_multibucket.py``.)"""
    f32_sparse_convs(monkeypatch)
    batch, _, _ = jax_ladder_batch()
    jmodel = jseg.MultimodalSeg(_ladder_spec(jseg, "raw"))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax_variables(jmodel, jb, seed=8, train=False)
    tmodel = tseg.MultimodalSeg(_ladder_spec(tseg, "raw"), device="cpu",
                                seed=None)
    load_flax_variables(tmodel, variables)
    tb = torch_batch(batch)
    assert "images" not in tb and "buckets" in tb["mappings"][0]
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                jb)
    with torch.no_grad():
        got = tmodel.eval()(tb)
    n = int(batch["graph"]["levels"][0]["valid"].sum())
    assert rel_err(got["logits"].numpy()[:n],
                   np.asarray(ref["logits"])[:n]) <= 1e-4
    np.testing.assert_array_equal(got["x_seen"].numpy(),
                                  np.asarray(ref["x_seen"]))
    ref_loss, ref_grads = _jax_loss_and_grads(jmodel, variables, jb)
    state = tstep.TrainState.create(tmodel, topt.make_optimizer(
        topt.make_schedule("constant", 0.1), grad_clip=10.0))
    _, metrics = tstep.make_train_step(tmodel)(state, tb, None)
    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    grads = flat_leaves(to_flax_tree(tmodel, "grads"))
    ref = flat_leaves(jax.device_get(ref_grads))
    assert sorted(grads) == sorted(ref)
    for k in ref:
        assert rel_err(grads[k], ref[k]) <= 1e-4, k


@pytest.mark.parametrize("kind,match", [
    ("shared", "shared_tower needs a flat image batch"),
    ("reuse", "tower-reuse branches need a flat image batch")])
def test_shared_and_reuse_refuse_a_ladder_batch(kind, match):
    batch, _, _ = jax_ladder_batch()
    model = tseg.MultimodalSeg(_ladder_spec(tseg, kind), device="cpu")
    with pytest.raises(ValueError, match=match):
        model(torch_batch(batch))
    jmodel = jseg.MultimodalSeg(_ladder_spec(jseg, kind))
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0),
            jax.tree_util.tree_map(jnp.asarray, batch), train=False))


@pytest.mark.parametrize("family", ["no3d", "late_feature"])
def test_tower_less_branch_in_the_other_families_matches_jax(monkeypatch,
                                                             family):
    """``make_tower(None)`` is ``(None, 3)`` for every family: a no3d and a
    late model with a raw-RGB branch, logits within 1e-4."""
    f32_sparse_convs(monkeypatch)
    batch = flat_batch()

    def spec(pkg):
        return pkg.ModelSpec(num_classes=4, backbone="Res16UNetTest",
                             family=family, branches=((0, pkg.BranchSpec(
                                 tower=None, out_channels=3,
                                 view_pool="max")),))

    jmodel = jseg.build_model(spec(jseg))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax_variables(jmodel, jb, seed=9, train=False)
    tmodel = tseg.build_model(spec(tseg), device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    assert tseg.make_tower(None) == (None, 3)
    with tt.f32_convs():
        ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jb)
        with torch.no_grad():
            got = tmodel.eval()(torch_batch(batch))
    n = int(batch["graph"]["levels"][0]["valid"].sum())
    assert rel_err(got["logits"].numpy()[:n],
                   np.asarray(ref["logits"])[:n]) <= 1e-4


# --- cli.train + cli.eval with ref: and data.ref on the CPU -------------------

_CLI = ["--device", "cpu", "data.voxel_size=0.1", "data.batch_size=2",
        "data.samples_per_epoch=4", "training.epochs=1",
        "training.tensorboard=false", "data.kwargs.image_size=[64, 32]",
        "data.kwargs.keep_raw=true"]


@pytest.mark.parametrize("kind,extra", [
    ("raw", []),                               # the ingested ladder is on
    ("shared", ["data.crop_ladder_min=0"]),    # flat batches
], ids=["raw-ladder", "shared-flat"])
def test_cli_train_and_eval_with_ref_names(conf, tmp_path, monkeypatch,
                                           kind, extra):
    """``model.name=ref:sparseconv3d/<entry>`` and
    ``data.ref=s3disfused-sparse`` through ``cli.train`` (one epoch and an
    eval) and ``cli.eval --voting_runs 2`` on the miniature S3DIS layout;
    ``run.json`` keeps both names, and ``cli.eval`` ingests them again."""
    monkeypatch.setenv("DVA_REFERENCE_CONF", str(conf / "models/segmentation"))
    monkeypatch.setenv("DVA_REFERENCE_DATA_CONF",
                       str(conf / "data/segmentation/multimodal"))
    root = fake_s3dis_layout(str(tmp_path / "raw"))
    run_dir = tmp_path / "run"
    name = f"ref:sparseconv3d/{KINDS[kind]}"
    metrics = cli_train.main([
        *_CLI, "data.ref=s3disfused-sparse", f"data.root={root}",
        f"model.name={name}", "model.overrides={backbone: Res16UNetTest}",
        f"training.run_dir={run_dir}", *extra])
    assert all(np.isfinite(v) for v in metrics.values())
    stored = json.loads((run_dir / "run.json").read_text())
    assert stored["model"]["name"] == name
    assert stored["data"]["ref"] == "s3disfused-sparse"
    assert stored["data"]["crop_ladder_min"] == (16 if kind == "raw" else 0)
    assert stored["data"]["kwargs"]["mapping_params"]["exact"] is True
    out = cli_eval.main(["--run_dir", str(run_dir), "--device", "cpu",
                         "--voting_runs", "2", *extra])
    assert "test_miou" in out and all(np.isfinite(v) for v in out.values())
