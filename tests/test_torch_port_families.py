"""The paper's other model families in the PyTorch port against the JAX
package: ``No3DSeg`` (one and two branches, with and without its head, the
per-view logits and the view-level loss) and ``LateFusionSeg`` (feature and
logit modes, two branches) on the tiny flat batch; a float32 train step of
each; the ``ignore_unseen`` default of ``make_train_step``;
``propagate_unseen``; the parameter count of every zoo name and grammar pool
at published widths; and ``cli.train`` + ``cli.eval`` with ``--device cpu``
for a no3d and a late model.

Float32 operands throughout (``f32_sparse_convs``, ``f32_convs``, float32
tower activations): only summation orders differ, so logits agree within
1e-4 of the largest magnitude (the bound of ``test_torch_port_model.py``),
the train step's loss within 1e-5 and its gradient leaves within 1e-4, as
``test_torch_port_train_step.py`` holds the flagship's.  The branches use
the nearest pixel gather, so that the atomic max has no bilinear ties for
the frameworks to break apart (ROADMAP C).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.models import losses as jlosses
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.models import losses as tlosses
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import branch as tbranch
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             flat_leaves, jax_tiny_batch, jax_variables,
                             rel_err, torch_batch)

# a small compact tower whose last conv emits the 4 classes per pixel (the
# light no3d model's shape): 64 x 32 -> 32 x 16 -> 64 x 32
_LOGIT_TOWER = (((4, 8, 3, 1, 1, 0), (8, 16, 2, 2, 0, 1)),
                ((16, 8, 8, 2, 2, 0, 1),), 4)


def _branch(pkg, **kw):
    base = dict(tower="resnet18_l1", out_channels=16, view_pool="group",
                num_groups=2, interpolate=False, tower_bf16=False)
    base.update(kw)
    return pkg.BranchSpec(**base)


def _logit_branch(pkg):
    return _branch(pkg, tower="scratch_unet", tower_cfg=_LOGIT_TOWER,
                   out_channels=4, atomic_reduce="max", view_pool="mean")


_FAMILIES = {
    # the light model's shape: a logit tower, mean pool, no head
    "no3d-light": lambda p: dict(family="no3d", no3d_head=False,
                                 branches=((0, _logit_branch(p)),)),
    "no3d-max-head": lambda p: dict(
        family="no3d", branches=((0, _branch(p, view_pool="max")),)),
    "no3d-two-head": lambda p: dict(
        family="no3d", branches=((0, _logit_branch(p)),
                                 (0, _branch(p, view_pool="group")))),
    "late-feature": lambda p: dict(
        family="late_feature",
        branches=((0, _branch(p)), (0, _branch(p, view_pool="max")))),
    "late-logit": lambda p: dict(
        family="late_logit",
        branches=((0, _branch(p)), (0, _branch(p, view_pool="max")))),
}


def _specs(kind):
    make = _FAMILIES[kind]
    return (jseg.ModelSpec(num_classes=4, backbone="Res16UNetTest",
                           **make(jseg)),
            tseg.ModelSpec(num_classes=4, backbone="Res16UNetTest",
                           **make(tseg)))


def _models(kind, seed=2):
    batch, _ = jax_tiny_batch()
    jspec, tspec = _specs(kind)
    jmodel = jseg.build_model(jspec)
    variables = jax_variables(jmodel, batch, seed=seed, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    return batch, jmodel, variables, tmodel


@pytest.mark.parametrize("kind", sorted(_FAMILIES))
def test_family_forward_matches_jax(monkeypatch, kind):
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _models(kind)
    assert type(tmodel).__name__ == type(jmodel).__name__
    with jt.f32_convs(), tt.f32_convs():
        ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, batch)
        with torch.no_grad():
            got = tmodel.eval()(torch_batch(batch))
    n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
    keys = {"logits", "x_seen"} | ({"view_extras"} if "no3d" in kind
                                   else set())
    if "view_logits" in ref:
        keys.add("view_logits")
    assert set(got) == keys == set(ref)
    assert rel_err(got["logits"].numpy()[:n],
                   np.asarray(ref["logits"])[:n]) <= 1e-4
    np.testing.assert_array_equal(got["x_seen"].numpy(),
                                  np.asarray(ref["x_seen"]))
    seen = got["x_seen"].numpy()
    assert seen[:n].any() and not seen[:n].all()
    if "no3d" in kind:
        # unseen points: zero pooled features, so the head's bias (or 0)
        assert np.ptp(got["logits"].numpy()[:n][~seen[:n]], axis=0).max() \
            <= 1e-6
        vv = np.asarray(ref["view_extras"]["view_valid"])
        for k in ("x_view", "view_point_id", "view_valid"):
            assert rel_err(got["view_extras"][k].numpy(),
                           np.asarray(ref["view_extras"][k])) <= 1e-5
        # view logits exactly where the per-view width is the pooled one
        assert ("view_logits" in got) == (kind != "no3d-two-head")
        if "view_logits" in got:
            assert rel_err(got["view_logits"].numpy()[vv],
                           np.asarray(ref["view_logits"])[vv]) <= 1e-4
    if kind == "no3d-light":
        assert tmodel.head is None
        assert "head" not in to_flax_tree(tmodel)


_OPT = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=10.0)


def _jax_loss(jmodel, variables, batch, ignore_unseen, view_loss_weight):
    """The loss of the JAX package's ``make_train_step`` and its gradient."""
    valid = jnp.asarray(batch["graph"]["levels"][0]["valid"])
    labels = jnp.asarray(batch["labels"])

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params,
             "batch_stats": variables.get("batch_stats", {})},
            batch, train=True, mutable=["batch_stats"])
        mask = valid & out["x_seen"] if ignore_unseen else valid
        loss = jlosses.segmentation_loss(out["logits"], labels, mask)
        if view_loss_weight and "view_logits" in out:
            ex = out["view_extras"]
            loss = loss + view_loss_weight * jlosses.view_level_loss(
                out["view_logits"], labels, ex["view_point_id"],
                ex["view_valid"])
        return loss

    return jax.jit(jax.value_and_grad(loss_fn))(variables["params"])


def _f64_tower_grads(tower, images, cot):
    """The parameter gradients of a ``resnet18_l*`` tower (a copy, cast to
    float64 here) for the cotangent ``cot [I, W, H, C]`` at its output, its
    convs and norms run in float64."""
    import torch.nn.functional as F

    def conv(self, x):
        kh, kw = self.kernel_size
        w = self.weight
        w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) * torch.rsqrt(
            w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            * (kh * kw * w.shape[1]) + 1e-10)
        return F.conv2d(x, w, stride=self.strides, dilation=self.dilation,
                        padding=(kh // 2 * self.dilation[0],
                                 kw // 2 * self.dilation[1]))

    def norm(self, x):
        g = self.GroupNorm_0
        return F.group_norm(x, g.num_groups, g.weight, g.bias, g.eps)

    t64 = tower.double()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt.Conv2dWS, "forward", conv)
        mp.setattr(tt._Norm, "forward", norm)
        y = t64(images.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        grads = torch.autograd.grad(y, list(t64.parameters()), cot.double())
    t64.float()
    for p, g in zip(t64.parameters(), grads):
        p.grad = g.float()
    return flat_leaves(to_flax_tree(t64, "grads"))


@pytest.mark.parametrize("kind", ["no3d-light", "no3d-two-head",
                                  "late-feature", "late-logit"])
def test_family_train_step_matches_jax(monkeypatch, kind):
    """One float32 train step of the port's ``make_train_step`` against the
    JAX package's: the metrics' loss (with the view-level loss where the
    model emits view logits, unseen points out of a no3d loss) within 1e-5,
    the gradient norm within 1e-4, every gradient leaf within 1e-4, but for
    the late models' group-pool tower (``branch/tower``).  There the JAX
    package's float32 gradient lies up to 4% (as a whole; 13% in its worst
    leaf) from a float64 evaluation of the same tower for the same
    cotangent, the port's within 1e-6 (when written): the tower's leaves are
    held to the port's own float64 gradient within 1e-5, and to the JAX one
    within 6e-2 as a whole."""
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _models(kind, seed=3)
    no3d = kind.startswith("no3d")
    seen = {}
    run_tower = tbranch.run_tower

    def recording(tower, images, *a, **k):
        y = run_tower(tower, images, *a, **k)
        if tower is tmodel.branch.tower and y.requires_grad:
            seen["images"] = images
            y.register_hook(lambda g: seen.__setitem__("cot", g))
        return y

    monkeypatch.setattr(tbranch, "run_tower", recording)
    tower_before = copy.deepcopy(tmodel.branch.tower)
    with jt.f32_convs(), tt.f32_convs():
        tx = jopt.make_optimizer(jopt.make_schedule("constant", 0.1), **_OPT)
        state = jstep.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, variables), tx)
        _, ref_m = jax.jit(jstep.make_train_step(jmodel, view_loss_weight=1.0))(
            state, batch, jax.random.PRNGKey(0))
        ref_loss, ref_grads = _jax_loss(jmodel, variables, batch, no3d, 1.0)
        tstate = tstep.TrainState.create(tmodel, topt.make_optimizer(
            topt.make_schedule("constant", 0.1), **_OPT))
        _, got_m = tstep.make_train_step(tmodel, view_loss_weight=1.0)(
            tstate, torch_batch(batch), None)
    assert abs(float(ref_m["loss"]) - float(ref_loss)) <= 1e-6 * abs(
        float(ref_loss))
    assert abs(float(got_m["loss"]) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    assert abs(float(got_m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
        1e-4 * float(ref_m["grad_norm"])
    grads = flat_leaves(to_flax_tree(tmodel, "grads"))
    ref = flat_leaves(jax.device_get(ref_grads))
    assert sorted(grads) == sorted(ref)
    tower = "branch/tower/" if kind.startswith("late") else None
    bad = {k: rel_err(grads[k], ref[k]) for k in ref
           if not (tower and k.startswith(tower))
           and not rel_err(grads[k], ref[k]) <= 1e-4}
    assert not bad, bad
    if tower:
        keys = [k for k in ref if k.startswith(tower)]
        f64 = _f64_tower_grads(tower_before, seen["images"], seen["cot"])
        assert sorted(tower + k for k in f64) == sorted(keys)
        bad = {k: rel_err(grads[tower + k], v) for k, v in f64.items()
               if not rel_err(grads[tower + k], v) <= 1e-5}
        assert not bad, bad
        num = sum(((grads[k] - ref[k]) ** 2).sum() for k in keys)
        den = sum((ref[k] ** 2).sum() for k in keys)
        assert np.sqrt(num / den) <= 6e-2


def test_ignore_unseen_defaults_to_the_family(monkeypatch):
    """``ignore_unseen=None``: a ``No3DSeg`` masks the points no view
    reaches out of its loss (the JAX package's default), a
    ``MultimodalSeg`` does not; the tiny batch holds unseen points."""
    f32_sparse_convs(monkeypatch)
    batch, jmodel, variables, tmodel = _models("no3d-max-head", seed=4)
    tb = torch_batch(batch)
    losses = {}
    with jt.f32_convs(), tt.f32_convs():
        for flag in (None, True, False):
            load_flax_variables(tmodel, variables)
            tstate = tstep.TrainState.create(tmodel, topt.make_optimizer(
                topt.make_schedule("constant", 0.0)))
            _, m = tstep.make_train_step(tmodel, ignore_unseen=flag)(
                tstate, tb, None)
            losses[flag] = float(m["loss"])
        ref_default, _ = _jax_loss(jmodel, variables, batch, True, 0.0)
        tx = jopt.make_optimizer(jopt.make_schedule("constant", 0.0))
        _, jm = jax.jit(jstep.make_train_step(jmodel))(
            jstep.TrainState.create(
                jax.tree_util.tree_map(jnp.asarray, variables), tx),
            batch, jax.random.PRNGKey(0))
    assert losses[None] == losses[True] != losses[False]
    assert abs(losses[None] - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert abs(float(jm["loss"]) - float(ref_default)) <= 1e-6
    # the other families keep every valid point in the loss
    mm = tseg.MultimodalSeg(tzoo.get_model_spec(
        "Res16UNet14-L1-early-group2", 4, 4, {"backbone": "Res16UNetTest"}),
        device="cpu", seed=0)
    a = tstep.make_train_step(mm)(tstep.TrainState.create(
        mm, topt.make_optimizer(topt.make_schedule("constant", 0.0))), tb,
        None)[1]["loss"]
    b = tstep.make_train_step(mm, ignore_unseen=False)(
        tstep.TrainState.create(mm, topt.make_optimizer(
            topt.make_schedule("constant", 0.0))), tb, None)[1]["loss"]
    assert float(a) == float(b)


@pytest.mark.parametrize("case", ["some", "all", "none"])
def test_propagate_unseen_matches_jax(case):
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 4, (500, 3)).astype(np.float32)
    logits = rng.normal(size=(500, 13)).astype(np.float32)
    seen = {"some": rng.random(500) < 0.6, "all": np.ones(500, bool),
            "none": np.zeros(500, bool)}[case]
    ref = jlosses.propagate_unseen(logits, pos, seen)
    got = tlosses.propagate_unseen(torch.from_numpy(logits),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(seen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "some":
        assert not np.array_equal(got.numpy(), logits)


# --- every zoo name at published widths --------------------------------------

_NAMES = sorted(jzoo.MODEL_ZOO) + [
    f"Res16UNet34-L4-early-{pool}" for pool in
    ("max", "mean-interpolate", "heuristic-interpolate", "qkv-interpolate",
     "group4-interpolate")]


@pytest.mark.parametrize("name", _NAMES)
def test_every_zoo_model_has_the_jax_parameter_count(name):
    """At the S3DIS recipe's 13 classes, as ``jax.eval_shape`` counts the
    flax model's parameters on the tiny batch (the port's model is built on
    the meta device)."""
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
    if name == "Res16UNet21-15_light":
        assert want == 4_367_085


@pytest.mark.parametrize("set_encoder", ["minmaxdiff", "mlp"])
def test_other_set_encoders_have_the_jax_parameter_count(set_encoder):
    name = "Res16UNet34-L4-early-group4-interpolate"
    specs = [dataclasses.replace(s, branches=tuple(
        (lvl, dataclasses.replace(b, set_encoder=set_encoder))
        for lvl, b in s.branches))
        for s in (jzoo.get_model_spec(name, 13, 4),
                  tzoo.get_model_spec(name, 13, 4))]
    batch, _ = jax_tiny_batch()
    shapes = jax.eval_shape(lambda: jseg.build_model(specs[0]).init(
        jax.random.PRNGKey(0), batch, train=False))
    want = flat_leaves(shapes["params"])
    model = tseg.build_model(specs[1], device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in want.values())
    assert any("view_pool/set_enc/" in k for k in want)


def test_tower_less_and_shared_branches_stay_refused():
    """Each of the ingest-only towers builds now: ``None`` (no tower: the
    branch pools the images' 3 channels), ``"reuse"`` (beside a branch
    with a tower of its own, which feeds both from one ``reuse_tower``)
    and ``"shared:0"`` (a tap of ``spec.shared_tower``); none of their
    branches owns a ``tower``.  The name is kept from when they were
    refused."""
    spec = tzoo.get_model_spec("Res16UNet14-L1-early-group2", 4, 4,
                               {"backbone": "Res16UNetTest"})
    (lvl, b), = spec.branches
    variants = {
        None: dict(branches=((lvl, dataclasses.replace(b, tower=None)),)),
        "reuse": dict(branches=((lvl, b), (2, dataclasses.replace(
            b, tower="reuse")))),
        "shared:0": dict(shared_tower=((16,), (1,), (1,)),
                         branches=((lvl, dataclasses.replace(
                             b, tower="shared:0")),)),
    }
    for tower, changes in variants.items():
        model = tseg.build_model(dataclasses.replace(spec, **changes),
                                 device="cpu")
        assert isinstance(model, tseg.MultimodalSeg)
        assert not any(getattr(br, "tower", None) is not None
                       for name, br in model.named_children()
                       if name.startswith("branch"))
        assert hasattr(model, "reuse_tower") == (tower == "reuse")
        assert hasattr(model, "shared_tower") == (tower == "shared:0")
    with pytest.raises(ValueError, match="a tower of its own"):
        tseg.build_model(dataclasses.replace(spec, branches=((lvl, (
            dataclasses.replace(b, tower="reuse"))),)), device="cpu")


# --- cli.train + cli.eval on the CPU -----------------------------------------

_CLI = ["--device", "cpu", "data.dataset=synthetic", "data.voxel_size=0.15",
        "data.radius=1.5", "data.image_slots=2", "data.samples_per_epoch=4",
        "data.batch_size=2", "data.image_size=[64, 32]", "training.epochs=1",
        "training.tensorboard=false",
        "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}"]


@pytest.mark.parametrize("model", [
    "Res16UNet21-15_light", "Res16UNet34-LateFeatureFusion"])
def test_cli_train_and_eval_on_the_cpu(tmp_path, monkeypatch, model):
    """The light no3d model (with the view-level loss) and the late feature
    model (on the test backbone) train for one epoch and evaluate with two
    voting runs; the no3d eval propagates onto unseen points.  Float32
    towers: the CPU's bf16 convolutions are not what the card runs."""
    f32_sparse_convs(monkeypatch)
    overrides = ("{tower_bf16: false}" if "light" in model
                 else "{backbone: Res16UNetTest, tower_bf16: false}")
    run_dir = tmp_path / "run"
    calls = []
    propagate = cli_eval.propagate_unseen
    monkeypatch.setattr(cli_eval, "propagate_unseen", lambda *a: (
        calls.append(a), propagate(*a))[1])
    torch.set_num_threads(2)
    with tt.f32_convs():
        metrics = cli_train.main(
            _CLI + [f"model.name={model}", f"model.overrides={overrides}",
                    f"data.root={tmp_path / 'data'}",
                    f"training.run_dir={run_dir}"]
            + (["training.view_loss_weight=1.0"] if "light" in model else []))
        assert np.isfinite(metrics["train_loss"])
        out = cli_eval.main(["--run_dir", str(run_dir), "--device", "cpu",
                             "--voting_runs", "2"])
    assert {"test_miou", "vote_miou"} <= set(out)
    assert bool(calls) == ("light" in model)
