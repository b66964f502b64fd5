"""The KITTI-360 recipes' models in the PyTorch port against the JAX package:
``ResNet18(pyramid=True)`` (every tap), the shared pyramid tower
``ResNet18Pyramid`` (taps resized bilinearly to the finest and concatenated,
with or without its 1x1 projection, either stem), the ``resnet18_pyramid`` /
``resnet18_pyramid_raw`` entries of ``make_tower``, the zoo's
``Res16UNet34-SharedPyramid-early-interpolate`` and
``Res16UNet34-PointPyramid-early-cityscapes-interpolate`` (five deep-stem
truncation towers as five branches at level 0), and tiny ``MultimodalSeg``s
with two and five branches at level 0 converted by ``from_jax`` both ways,
on a flat batch and on a camera-family ladder batch.

Float32 operands throughout (``f32_convs``, ``f32_sparse_convs``), so the
two frameworks differ in summation order only: towers within 1e-5 of the
largest magnitude (at image sizes that are not multiples of 32, so that the
resizes run at non-integer scales), whole models' logits within 1e-4, the
loss of a train step within 1e-5 and its gradient leaves within 1e-4 (on the
ladder batch, the leaves of the level-0 branches and the stem within 1e-2:
the JAX package's own float32 noise through the ladder pool's set-encoder
norm, see ``test_torch_port_multibucket.py``).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.data.toy import toy_samples
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.models.losses import segmentation_loss as jax_seg_loss
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.ops import voxel as jvox
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves, jax_tiny_batch,
                             jax_variables, rel_err, torch_batch,
                             window_image)

SHARED = "Res16UNet34-SharedPyramid-early-interpolate"
POINT = "Res16UNet34-PointPyramid-early-cityscapes-interpolate"
# images whose taps sit at non-integer scales: 88 x 47 gives taps of 22 x 12,
# 22 x 12, 11 x 6, 6 x 3 and 3 x 2 (7x7 stem); the recipe's 188 rows give
# 47, 47, 24, 12 and 6
IMAGES = (2, 88, 47, 3)


def _images(shape=IMAGES, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class _JaxRun(fnn.Module):
    """The JAX branch's tower call: ``run_tower`` on a tower named 'tower'."""

    make: object

    @fnn.compact
    def __call__(self, images):
        return jt.run_tower(self.make(name="tower"), images, False,
                            remat=False, bf16=False)


class _TorchRun(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.tower = tower


# --- the towers ---------------------------------------------------------------

@pytest.mark.parametrize("deep_stem", [False, True])
def test_resnet18_pyramid_taps_match_jax(deep_stem):
    """``ResNet18(pyramid=True)``: the max-pooled stem and every layer's
    output, each within 1e-5, with its channel count."""
    images = _images()
    jtower = jt.ResNet18(out_level=4, pyramid=True, deep_stem=deep_stem)
    variables = jax_variables(jtower, images, seed=2)
    ttower = tt.ResNet18(out_level=4, pyramid=True, deep_stem=deep_stem,
                         device="cpu")
    load_flax_variables(ttower, variables)
    with jt.f32_convs():
        ref = [np.asarray(t) for t in jax.jit(
            lambda v, x: jtower.apply(v, x, train=False))(variables, images)]
    with torch.no_grad(), tt.f32_convs():
        got = [t.permute(0, 2, 3, 1).numpy() for t in ttower(
            torch.from_numpy(images).permute(0, 3, 1, 2))]
    assert len(got) == len(ref) == 5
    assert ttower.tap_channels == [t.shape[-1] for t in ref] == [
        128 if deep_stem else 64, 64, 128, 256, 512]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(g, r) <= 1e-5


@pytest.mark.parametrize("n_in,n_out", [(47, 47), (24, 47), (12, 47),
                                        (6, 47), (11, 22), (3, 22), (2, 12)])
def test_tap_resize_is_jax_bilinear(n_in, n_out):
    """The pyramid's upsampling (``F.interpolate``, bilinear, half-pixel
    centres) against ``jax.image.resize(..., "bilinear")`` (antialiased,
    which an upsampling does not engage) at the recipe's and the tests'
    scales, in both axes."""
    x = np.random.default_rng(n_in).normal(size=(2, n_in, n_in + 3, 5)
                                           ).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, n_out, n_out + 5, 5),
                                      "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(n_out, n_out + 5), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("deep_stem", [False, True])
@pytest.mark.parametrize("project", [True, False])
def test_resnet18_pyramid_matches_jax(project, deep_stem):
    """``ResNet18Pyramid`` through each package's ``run_tower`` within 1e-5,
    at 1024 / 1088 raw channels or projected to ``out_channels``."""
    images = _images()
    jrun = _JaxRun(functools.partial(jt.ResNet18Pyramid, out_channels=24,
                                     deep_stem=deep_stem, project=project))
    variables = jax_variables(jrun, images, seed=4)
    trun = _TorchRun(tt.ResNet18Pyramid(out_channels=24, deep_stem=deep_stem,
                                        project=project, device="cpu"))
    load_flax_variables(trun, variables)
    with jt.f32_convs():
        ref = np.asarray(jax.jit(jrun.apply)(variables, images))
    with torch.no_grad(), tt.f32_convs():
        got = tt.run_tower(trun.tower, torch.from_numpy(images),
                           bf16=False).numpy()
    want_c = 24 if project else (1088 if deep_stem else 1024)
    assert got.shape == ref.shape == (2, 22, 12, want_c)
    assert trun.tower.out_channels == want_c
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("name", ["resnet18_pyramid", "resnet18_pyramid_raw"])
@pytest.mark.parametrize("deep_stem", [False, True])
def test_make_tower_pyramid_entries(name, deep_stem):
    """The two pyramid entries give the JAX registry's channel counts."""
    tower, c = tseg.make_tower(name, deep_stem=deep_stem, device="cpu")
    _, want = jseg.make_tower(name, deep_stem=deep_stem)
    assert c == want == tower.out_channels
    assert isinstance(tower, tt.ResNet18Pyramid)
    assert tower.project == (name == "resnet18_pyramid")


# --- the zoo's KITTI-360 models --------------------------------------------------

def _zoo_spec(pkg, name, num_classes=19):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the towers train from scratch
        return pkg.get_model_spec(name, num_classes, 4)


@pytest.mark.parametrize("name", [SHARED, POINT])
def test_kitti360_specs_match_jax(name):
    """Both KITTI-360 zoo entries give the JAX package's spec field by
    field; the PointPyramid is five deep-stem truncations at level 0,
    pooled 32 / 32 / 64 / 128 / 256 with group-4 attention, concatenated."""
    got, want = _zoo_spec(tzoo, name), _zoo_spec(jzoo, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == POINT:
        assert [lvl for lvl, _ in got.branches] == [0] * 5
        assert [b.tower for _, b in got.branches] == [
            f"resnet18_l{i}" for i in range(5)]
        assert [b.out_channels for _, b in got.branches] == [32, 32, 64,
                                                              128, 256]
        assert all(b.tower_deep_stem and b.num_groups == 4
                   and b.fusion_mode == "concat" for _, b in got.branches)
    else:
        (_, b), = got.branches
        assert b.tower == "resnet18_pyramid" and not b.tower_deep_stem


@pytest.mark.parametrize("name", [SHARED, POINT])
def test_kitti360_models_build_with_the_jax_parameter_count(name):
    """``build_model`` of both entries at their published widths: the JAX
    model's parameter count, branch names ``branch_l0`` .. ``branch_l0_4``
    and the towers' channels (the SharedPyramid was refused before)."""
    spec = _zoo_spec(tzoo, name)
    batch, _ = jax_tiny_batch()
    shapes = jax.eval_shape(lambda: jseg.build_model(
        _zoo_spec(jzoo, name)).init(jax.random.PRNGKey(0), batch,
                                    train=False))
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = tseg.build_model(spec, device="cpu", seed=None)
    assert sum(p.numel() for p in model.parameters()) == want
    names = [n for n, _ in model.named_children() if n.startswith("branch")]
    assert names == sorted(shapes["params"])[:len(names)]
    if name == POINT:
        assert names == ["branch_l0"] + [f"branch_l0_{k}" for k in (1, 2, 3,
                                                                     4)]
        assert want == 54_099_471
        assert [getattr(model, n).tower.num_stem for n in names] == [3] * 5
    else:
        assert names == ["branch_l0"]
        assert isinstance(model.branch_l0.tower, tt.ResNet18Pyramid)


# --- several branches at level 0 ------------------------------------------------

# (tower, out_channels) of the tiny models' level-0 branches, with the deep
# stem as the recipe's towers
BRANCHES = {
    2: (("resnet18_l1", 16), ("resnet18_l0", 8)),
    5: tuple((f"resnet18_l{i}", c) for i, c in enumerate((8, 8, 8, 16, 16))),
}
# the family ladder of the tiny ladder batch: 64 x 32 frames and 32 x 32
# "fisheyes"
LADDER = ((64, 32), (32, 32))


def _multi_specs(n: int, interpolate: bool):
    def build(flagship, branch_spec):
        spec = flagship(**TINY_SPEC)
        (_, b0), = spec.branches
        branches = tuple(
            (0, dataclasses.replace(b0, tower=tower, out_channels=c,
                                    tower_deep_stem=True,
                                    interpolate=interpolate,
                                    tower_bf16=False))
            for tower, c in BRANCHES[n])
        return dataclasses.replace(spec, branches=branches)

    return (build(jax_flagship_spec, jseg.BranchSpec),
            build(flagship_spec, tseg.BranchSpec))


@functools.lru_cache(maxsize=None)
def family_ladder_batch():
    """A JAX-package batch of two samples with two 64 x 32 images each, the
    second image of each sample a 32 x 32 "fisheye" (its pixels windowed
    into the canvas corner), collated on the camera-family ladder
    ``LADDER`` (each image's bucket its family, at origin 0)."""
    a, b = toy_samples(2, 30.0, LADDER[0], 2, 0.15, 0)
    fw, fh = LADDER[1]
    samples = [dataclasses.replace(window_image(s, 1, 0, 0, fw - 1, fh - 1),
                                   image_family=np.array([0, 1]))
               for s in (a, b)]
    views = sum(s.mapping.num_views for s in samples)
    pix = sum(s.mapping.num_pixels for s in samples)
    coords = np.concatenate([
        np.concatenate([np.full((len(s.coords), 1), i, np.int32), s.coords], 1)
        for i, s in enumerate(samples)])
    counts, cur, stride = [len(coords)], coords, 1
    for _ in range(4):
        cur, _ = jvox.downsample_coords(cur, stride * 2)
        stride *= 2
        counts.append(len(cur))

    def cap(x, m=64):
        return int(-(-int(x * 1.2) // m) * m)

    bucket = jcollate.Bucket(
        level_caps=[cap(c) for c in counts], num_batches=2,
        view_cap=cap(views), pix_cap=cap(pix), image_ladder=list(LADDER),
        ladder_image_caps=[2, 2], ladder_pix_caps=[cap(pix), cap(pix)])
    batch = jcollate.collate(samples, bucket, branch_levels=[0])
    return {k: v for k, v in batch.items() if k != "meta"}


@functools.lru_cache(maxsize=None)
def _step_both(n: int, kind: str):
    """Eval logits, then the loss and gradients of one train step of the
    ``n``-branch model in both packages from the same converted variables
    (float32 operands), on the tiny flat batch (nearest gather, see
    ``test_multi_branch_train_step_matches_jax``) or the family-ladder
    batch (whose gather is bilinear)."""
    batch = jax_tiny_batch()[0] if kind == "flat" else family_ladder_batch()
    jspec, tspec = _multi_specs(n, interpolate=kind != "flat")
    jmodel = jseg.MultimodalSeg(jspec)
    variables = jax_variables(jmodel, batch, seed=5, train=False)
    tmodel = tseg.MultimodalSeg(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    valid = batch["graph"]["levels"][0]["valid"]
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jt.f32_convs(), tt.f32_convs():
            @jax.jit
            def loss_and_grads(params, stats):
                def loss_fn(p):
                    out, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                          batch, train=True,
                                          mutable=["batch_stats"])
                    return jax_seg_loss(out["logits"], batch["labels"], valid)
                return jax.value_and_grad(loss_fn)(params)

            ref = {"logits": np.asarray(jax.jit(lambda v: jmodel.apply(
                v, batch, train=False)["logits"])(variables))}
            loss, grads = loss_and_grads(
                jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                variables["batch_stats"])
            ref["loss"], ref["grads"] = float(loss), jax.device_get(grads)
            tb = torch_batch(batch)
            with torch.no_grad():
                got = {"logits": tmodel.eval()(tb)["logits"].numpy()}
            state = tstep.TrainState.create(tmodel, topt.make_optimizer(
                topt.make_schedule("constant", 0.1), grad_clip=10.0))
            _, metrics = tstep.make_train_step(tmodel)(state, tb, None)
    got["loss"] = float(metrics["loss"])
    got["grads"] = to_flax_tree(tmodel, "grads")
    got["model"], got["variables"] = tmodel, variables
    got["n"] = int(np.asarray(valid).sum())
    return ref, got


CASES = [(2, "flat"), (5, "flat"), (2, "ladder"), (5, "ladder")]
IDS = [f"{n}_branches_{kind}" for n, kind in CASES]


def _l2_rel(got: dict, want: dict, keys) -> float:
    d = sum(((np.asarray(got[k], np.float64) - want[k]) ** 2).sum()
            for k in keys)
    w = sum((np.asarray(want[k], np.float64) ** 2).sum() for k in keys)
    return float(np.sqrt(d / w))


@pytest.mark.parametrize("n,kind", CASES, ids=IDS)
def test_multi_branch_logits_match_jax(n, kind):
    ref, got = _step_both(n, kind)
    k = got["n"]
    assert np.isfinite(got["logits"]).all()
    assert rel_err(got["logits"][:k], ref["logits"][:k]) <= 1e-4


@pytest.mark.parametrize("n,kind", CASES, ids=IDS)
def test_multi_branch_train_step_matches_jax(n, kind):
    """The loss within 1e-5 and every gradient leaf within 1e-4, every
    branch's tower getting a gradient, but for three groups of leaves whose
    float32 gradient is decided by rounding in either framework:

    * the ``resnet18_l0`` tower behind a bilinear gather (every ladder
      batch): its output is the stem's max-pool, whose overlapping windows
      repeat a value in neighbouring cells; the bilinear taps between equal
      cells are ties of the atomic max that each framework's rounding
      breaks its own way (ROADMAP C), so the tower's leaves are checked
      nonzero only.  The flat batch takes the nearest gather
      (``interpolate=False``), where those ties are exact and routed alike:
      there the l0 tower's leaves hold 1e-4;
    * the branches of the ``resnet18_l3`` and ``resnet18_l4`` towers on the
      flat batch's 64 x 32 images, maps of 4 x 2 and 2 x 1 cells (group
      norms over eight and two pixels): each branch held at 1e-3 as a
      whole (when written: 1.5e-5 and 1.4e-4; 1.1e-4 and 5.5e-3 in the
      worst leaf);
    * on the ladder batch, the other level-0 branches' pools and the stem:
      1e-2, the JAX package's own float32 noise through the ladder pool's
      set-encoder norm (``test_torch_port_multibucket.py``)."""
    ref, got = _step_both(n, kind)
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    grads, want = flat_leaves(got["grads"]), flat_leaves(ref["grads"])
    assert sorted(grads) == sorted(want)
    names = ["branch_l0"] + [f"branch_l0_{k}" for k in range(1, n)]
    towers = dict(zip(names, (t for t, _ in BRANCHES[n])))
    unchecked = tuple(f"{b}/tower/" for b, t in towers.items()
                      if t == "resnet18_l0" and kind == "ladder")
    whole = tuple(f"{b}/" for b, t in towers.items()
                  if t in ("resnet18_l3", "resnet18_l4") and kind == "flat")
    loose = ("branch_l0", "stem/") if kind == "ladder" else ()
    bad = {}
    for k in want:
        if k.startswith(unchecked + whole):
            continue
        err = rel_err(grads[k], want[k])
        if not err <= (1e-2 if k.startswith(loose) else 1e-4):
            bad[k] = err
    assert not bad, bad
    for prefix in whole:
        keys = [k for k in want if k.startswith(prefix)]
        assert _l2_rel(grads, want, keys) <= 1e-3, prefix
    for name in names:
        tower = [v for k, v in grads.items()
                 if k.startswith(f"{name}/tower/")]
        assert tower and all(np.isfinite(g).all() and np.abs(g).max() > 0
                             for g in tower), name


@pytest.mark.parametrize("n", [2, 5])
def test_multi_branch_converts_both_ways(n):
    """``from_jax`` fills every ``branch_l0_k`` and ``to_flax_tree`` gives
    the flax tree back leaf for leaf, bit for bit."""
    _, got = _step_both(n, "flat")
    model = tseg.MultimodalSeg(_multi_specs(n, False)[1], device="cpu",
                               seed=None)
    load_flax_variables(model, got["variables"])
    back = flat_leaves(to_flax_tree(model, "params"))
    want = flat_leaves(got["variables"]["params"])
    assert sorted(back) == sorted(want)
    assert {k.split("/")[0] for k in back if k.startswith("branch")} == {
        "branch_l0", *(f"branch_l0_{k}" for k in range(1, n))}
    for k in want:
        assert back[k].tobytes() == np.asarray(want[k], np.float32).tobytes()


def test_five_branches_keep_five_ladder_wrappers():
    """Each level-0 branch takes a ladder batch through its own
    ``MultiBucketBranch.over`` wrapper, keyed by its name, over its own
    tower, view pool and fusion; none is a registered module."""
    _, got = _step_both(5, "ladder")
    model = got["model"]
    names = ["branch_l0"] + [f"branch_l0_{k}" for k in range(1, 5)]
    assert sorted(model._ladder) == sorted(names)
    for name in names:
        wrapper, branch = model._ladder[name], getattr(model, name)
        assert wrapper.tower is branch.tower
        assert wrapper.view_pool is branch.view_pool
        assert wrapper.fusion is branch.fusion
    assert len({id(w) for w in model._ladder.values()}) == 5
    assert len({id(w.tower) for w in model._ladder.values()}) == 5
    assert not any("_ladder" in n for n, _ in model.named_modules())
