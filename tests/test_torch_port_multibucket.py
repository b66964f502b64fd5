"""The crop-ladder branch of the PyTorch port against the JAX package, on the
JAX package's collated ladder batch (``torch_port_util.jax_ladder_batch``:
views spread over three buckets, one bucket without an image, mappings at
levels 0 and 1): ``MultiBucketBranch._gather`` through each of its paths with
its gradient, ``SegmentPool``, the whole ``MultiBucketBranch`` with its
parameter gradients, and ``MultimodalSeg`` with branches at levels 0 and 1
(eval logits, one train step).  float32 operands agree to 1e-5 per module
(whole model: logits and gradient leaves 1e-4, loss 1e-5: only summation
orders differ); the production bf16 operands to the looser bounds of the
flat-batch train step (loss 2e-3, gradient norm 5e-2)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.models import segmentation as jsegm
from deepviewagg_tpu.models.losses import segmentation_loss as jax_seg_loss
from deepviewagg_tpu.modules import gather as jgather
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.modules import multibucket as jmb
from deepviewagg_tpu.modules import pooling as jpool
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models import segmentation as tsegm
from deepviewagg_tpu_torch.modules import gather as tgather
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import multibucket as tmb
from deepviewagg_tpu_torch.modules import pooling as tpool
from deepviewagg_tpu_torch.ops import segment as tseg
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves, jax_ladder_batch,
                             jax_tiny_batch, jax_variables, rel_err,
                             torch_batch)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- _gather -----------------------------------------------------------------

@pytest.mark.parametrize("path", ["scale1", "upsampled", "four_tap"])
def test_gather_matches_jax_with_its_gradient(path):
    batch, _, _ = jax_ladder_batch()
    bucket = dict(batch["mappings"][0]["buckets"][3])
    w, h = batch["bucket_images"][3].shape[1:3]
    if path == "four_tap":      # a sparse pixel table, half of it padding
        n = int(bucket["pix_valid"].sum())
        bucket = {k: v[n - 20:n + 20] for k, v in bucket.items()
                  if k != "pix_ptr"}
    size = (w, h) if path == "scale1" else (w // 4, h // 4)
    maps = _rand((2,) + size + (6,), seed=1)
    rows = len(bucket["pix_x"])
    weight = _rand((rows, 6), seed=2)
    if path != "scale1":
        for mod in (jgather, tgather):
            assert mod._use_upsample(2, w, h, 6, rows, 4) == (path == "upsampled")

    jb = {k: jnp.asarray(v) for k, v in bucket.items()}
    ref, ref_grad = jax.value_and_grad(
        lambda m: (jmb.MultiBucketBranch._gather(m, jb, (w, h))
                   * weight).sum())(jnp.asarray(maps))
    ref_out = np.asarray(jmb.MultiBucketBranch._gather(
        jnp.asarray(maps), jb, (w, h)))

    tmaps = torch.from_numpy(maps).requires_grad_()
    out = tmb.MultiBucketBranch._gather(tmaps, torch_batch(bucket), (w, h))
    (out * torch.from_numpy(weight)).sum().backward()
    assert out.shape == ref_out.shape == (rows, 6)
    assert rel_err(out.detach().numpy(), ref_out) <= 1e-5
    assert rel_err(tmaps.grad.numpy(), np.asarray(ref_grad)) <= 1e-5
    ok = bucket["pix_valid"]
    assert ok.any() and not ok.all()
    assert not out.detach().numpy()[~ok].any()          # invalid rows -> 0
    if path == "scale1":
        exact = maps[bucket["pix_image"][ok], bucket["pix_x"][ok],
                     bucket["pix_y"][ok]]
        np.testing.assert_array_equal(out.detach().numpy()[ok], exact)


def test_row_gather_differentiates_through_index_select():
    """``_rows`` is ``flat[idx]`` with ``index_select``'s backward (an
    ``index_add_``, atomics on CUDA) in place of ``index_put_`` with
    accumulate; rows hit several times add up the same."""
    flat = torch.from_numpy(_rand((7, 3))).requires_grad_()
    idx = torch.tensor([6, 0, 6, 2, 2, 2, 5])
    weight = torch.from_numpy(_rand((7, 3), seed=1))
    out = tgather._rows(flat, idx)
    assert type(out.grad_fn).__name__ == "IndexSelectBackward0"
    assert torch.equal(out, flat[idx])
    (grad,) = torch.autograd.grad((out * weight).sum(), flat)
    (ref,) = torch.autograd.grad((flat[idx] * weight).sum(), flat)
    assert rel_err(grad.numpy(), ref.numpy()) <= 1e-6
    assert not grad[[1, 3, 4]].any()


def test_gather_clips_the_image_index():
    bucket = {"pix_image": np.array([0, 5, -3], np.int32),
              "pix_x": np.array([1, 2, 3], np.int32),
              "pix_y": np.array([0, 1, 1], np.int32),
              "pix_valid": np.array([True, True, True])}
    maps = _rand((2, 4, 2, 3))
    got = tmb.MultiBucketBranch._gather(torch.from_numpy(maps),
                                        torch_batch(bucket), (4, 2)).numpy()
    ref = np.asarray(jmb.MultiBucketBranch._gather(
        jnp.asarray(maps), {k: jnp.asarray(v) for k, v in bucket.items()},
        (4, 2)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, maps[[0, 1, 0], [1, 2, 3], [0, 1, 1]])


# --- SegmentPool -------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["max", "mean", "min", "sum"])
def test_segment_pool_matches_jax(reduce):
    view = jax_ladder_batch()[0]["mappings"][0]["view"]
    s = len(view["point_ptr"]) - 1
    x = _rand((len(view["view_valid"]), 12), seed=3)
    ref = jpool.SegmentPool(reduce).apply(
        {}, jnp.asarray(x), jnp.asarray(view["point_id"]),
        jnp.asarray(view["view_valid"]), s, ptr=jnp.asarray(view["point_ptr"]))
    tv = torch_batch(view)
    pool = tpool.SegmentPool(reduce)
    got = pool(torch.from_numpy(x), tv["point_id"], tv["view_valid"], s,
               ptr=tv["point_ptr"])
    assert not list(pool.parameters())
    assert got.shape == (s, 12)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5


# --- an all-empty bucket through the segment ops -----------------------------

@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_bucket_without_a_pixel_pools_to_zero_and_passes_no_gradient(reduce):
    """Bucket 0 of the ladder batch: every row masked, every view an empty
    segment.  The sum over buckets is exact only because it gives 0."""
    b = torch_batch(jax_ladder_batch()[0]["mappings"][0]["buckets"][0])
    assert not b["pix_valid"].any()
    vc = len(b["pix_ptr"]) - 2
    assert b["pix_ptr"][:-1].eq(0).all() and b["pix_ptr"][-1] == 64
    x = torch.from_numpy(_rand((64, 5), seed=4)).requires_grad_()
    out = tseg.segment_reduce(x, b["pix_view"], vc + 1, reduce,
                              valid=b["pix_valid"], ptr=b["pix_ptr"])
    assert out.shape == (vc + 1, 5) and not out.detach().any()
    out.backward(torch.ones_like(out))
    assert not x.grad.any()


# --- MultiBucketBranch -------------------------------------------------------

def _branches(view_pool="group", **kw):
    jb = jmb.MultiBucketBranch(
        tower=functools.partial(jt.ResNet18, out_level=1, name="tower"),
        out_channels=24, num_groups=4, view_pool=view_pool, tower_bf16=False,
        fusion_mode="concatenation", **kw)
    tb = tmb.MultiBucketBranch(
        tt.ResNet18(out_level=1), 64, 4, 24, num_groups=4,
        view_pool=view_pool, tower_bf16=False, fusion_mode="concatenation",
        **kw)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _branch_run(view_pool, frozen=False):
    """Training-mode forward and parameter gradients of ``sum(out * w)`` in
    both packages: ``(ref, got)`` dicts of out / seen / grads."""
    batch, _, _ = jax_ladder_batch()
    mm, images, x3d = batch["mappings"][0], batch["bucket_images"], batch["feats"]
    jb, tb = _branches(view_pool, frozen=frozen)
    variables = jax_variables(jb, x3d, mm, seed=5, train=False,
                              bucket_images=images)
    assert sorted(variables["params"]) == (
        ["tower", "view_pool"] if view_pool == "group" else ["tower"])
    weight = _rand((x3d.shape[0], 4 + (24 if view_pool == "group" else 64)), 6)
    stats = variables.get("batch_stats", {})

    def loss(params):
        (out, seen), _ = jb.apply(
            {"params": params, "batch_stats": stats}, x3d, mm, train=True,
            bucket_images=images, mutable=["batch_stats"])
        return (out * weight).sum(), (out, seen)

    with jt.f32_convs():
        (_, (out, seen)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
    ref = {"out": np.asarray(out), "seen": np.asarray(seen),
           "grads": jax.device_get(grads)}

    load_flax_variables(tb, variables)
    tb.train()
    tbatch = torch_batch(batch)
    with tt.f32_convs():
        t_out, t_seen = tb(tbatch["feats"], tbatch["mappings"][0],
                           bucket_images=tbatch["bucket_images"])
        (t_out * torch.from_numpy(weight)).sum().backward()
    got = {"out": t_out.detach().numpy(), "seen": t_seen.numpy(), "model": tb}
    return ref, got


@pytest.mark.parametrize("view_pool", ["group", "max"])
def test_multibucket_branch_forward_matches_jax(view_pool):
    ref, got = _branch_run(view_pool)
    assert got["out"].shape == ref["out"].shape
    assert rel_err(got["out"], ref["out"]) <= 1e-5
    np.testing.assert_array_equal(got["seen"], ref["seen"])
    assert got["seen"].any() and not got["seen"].all()


@pytest.mark.parametrize("view_pool,tol", [("group", 1e-5), ("max", 2e-3)])
def test_multibucket_branch_parameter_gradients_match_jax(view_pool, tol):
    """The parameter-free pool hands the raw cotangent (of order 1 here) to
    the atomic max, and there one near-tie decides: the upsampled maps
    replicate their border cells, so the two pixels of a border half-cell are
    equal in exact arithmetic and equal or one ulp apart in float32,
    depending on the order of the resize matmul's sum.  Both packages give
    every max-attaining element the full cotangent, so where one sees a tie
    and the other does not, that cell's gradient differs by one cotangent:
    here one such pair (of 5120 x 64 elements) moves one channel's tower
    gradient by 1e-3 of the leaf's largest entry.  Behind the attention pool
    the same pair stays under 1e-5."""
    ref, got = _branch_run(view_pool)
    grads = flat_leaves(to_flax_tree(got["model"], "grads"))
    want = flat_leaves(ref["grads"])
    assert sorted(grads) == sorted(want)
    bad = {k: rel_err(grads[k], want[k]) for k in want
           if not rel_err(grads[k], want[k]) <= tol}
    assert not bad, bad
    assert all(np.abs(g).max() > 0 for g in grads.values())


def test_frozen_branch_matches_jax_and_gives_the_tower_no_gradient():
    ref, got = _branch_run("group", frozen=True)
    assert rel_err(got["out"], ref["out"]) <= 1e-5
    live, _ = _branch_run("group")
    np.testing.assert_array_equal(ref["out"], live["out"])    # same forward
    tb = got["model"]
    assert all(p.grad is None for p in tb.tower.parameters())
    assert all(not np.asarray(g).any()
               for g in flat_leaves(ref["grads"]["tower"]).values())
    pool = {k: p.grad for k, p in tb.view_pool.named_parameters()}
    assert all(g is not None and g.abs().max() > 0 for g in pool.values())
    want = flat_leaves(ref["grads"]["view_pool"])
    tb.tower.requires_grad_(False)       # to_flax_tree is strict on gradients
    grads = flat_leaves(to_flax_tree(tb.view_pool, "grads"))
    assert all(rel_err(grads[k], want[k]) <= 1e-5 for k in want)


def test_bucket_without_images_is_skipped_and_no_images_raises():
    batch, _, _ = jax_ladder_batch()
    assert batch["bucket_images"][0].shape[0] == 0
    _, tb = _branches()
    tsegm.init_parameters(tb, torch.Generator().manual_seed(0))
    tbatch = torch_batch(batch)
    towers = []
    tb.tower.register_forward_hook(lambda m, a, o: towers.append(a[0].shape))
    with torch.no_grad():
        tb.eval()(tbatch["feats"], tbatch["mappings"][0],
                  bucket_images=tbatch["bucket_images"])
    assert [tuple(s[2:]) for s in towers] == [(16, 8), (32, 16), (64, 32)]
    empty = [im[:0] for im in tbatch["bucket_images"]]
    with pytest.raises(ValueError, match="no bucket carries images"):
        tb(tbatch["feats"], tbatch["mappings"][0], bucket_images=empty)


def test_images_inside_the_bucket_dicts_take_precedence():
    batch, _, _ = jax_ladder_batch()
    tbatch = torch_batch(batch)
    _, tb = _branches()
    tsegm.init_parameters(tb, torch.Generator().manual_seed(0))
    tb.eval()
    mm = tbatch["mappings"][0]
    inside = {"view": mm["view"], "buckets": [
        dict(b, images=im) for b, im in zip(mm["buckets"],
                                            tbatch["bucket_images"])]}
    with torch.no_grad():
        a, _ = tb(tbatch["feats"], mm, bucket_images=tbatch["bucket_images"])
        b, _ = tb(tbatch["feats"], inside)
    assert torch.equal(a, b)


# --- MultimodalSeg on a ladder batch -----------------------------------------

def _specs(f32: bool, **branch_kw):
    def build(flagship, branch_spec):
        spec = flagship(**TINY_SPEC)
        (_, b0), = spec.branches
        b1 = branch_spec(tower="resnet18_l1", out_channels=32, num_groups=2)
        branches = tuple(
            (lvl, dataclasses.replace(b, tower_bf16=not f32, **branch_kw))
            for lvl, b in ((0, b0), (1, b1)))
        return dataclasses.replace(spec, branches=branches)

    return (build(jax_flagship_spec, jsegm.BranchSpec),
            build(flagship_spec, tsegm.BranchSpec))


def _ladder_models(f32: bool):
    batch, _, _ = jax_ladder_batch()
    jspec, tspec = _specs(f32)
    jmodel = jsegm.MultimodalSeg(jspec)
    variables = jax_variables(jmodel, batch, seed=7, train=False)
    tmodel = tsegm.MultimodalSeg(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel, batch


def _step_both(f32: bool):
    """Eval logits, then the loss and gradients of one train step in both
    packages (the port's through ``make_train_step``)."""
    jmodel, variables, tmodel, batch = _ladder_models(f32)
    valid = batch["graph"]["levels"][0]["valid"]

    @jax.jit
    def loss_and_grads(params, stats):
        def loss_fn(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": stats}, batch,
                                  train=True, mutable=["batch_stats"])
            return jax_seg_loss(out["logits"], batch["labels"], valid)
        return jax.value_and_grad(loss_fn)(params)

    ref = {"logits": np.asarray(jax.jit(
        lambda v: jmodel.apply(v, batch, train=False)["logits"])(variables))}
    loss, grads = loss_and_grads(variables["params"], variables["batch_stats"])
    ref["loss"], ref["grads"] = float(loss), jax.device_get(grads)

    tb = torch_batch(batch)
    with torch.no_grad():
        got = {"logits": tmodel.eval()(tb)["logits"].numpy()}
    state = tstep.TrainState.create(tmodel, topt.make_optimizer(
        topt.make_schedule("constant", 0.1), grad_clip=10.0))
    _, metrics = tstep.make_train_step(tmodel)(state, tb, None)
    got["loss"] = float(metrics["loss"])
    got["grad_norm"] = float(metrics["grad_norm"])
    got["grads"] = to_flax_tree(tmodel, "grads")
    ref["grad_norm"] = float(np.sqrt(sum(
        (np.asarray(g, np.float64) ** 2).sum()
        for g in flat_leaves(ref["grads"]).values())))
    got["n"] = ref["n"] = int(np.asarray(valid).sum())
    return ref, got


@pytest.fixture(scope="module")
def f32_step():
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jt.f32_convs(), tt.f32_convs():
            return _step_both(f32=True)


def test_ladder_model_logits_match_jax(f32_step):
    ref, got = f32_step
    n = ref["n"]
    assert np.isfinite(got["logits"]).all()
    assert rel_err(got["logits"][:n], ref["logits"][:n]) <= 1e-4


def test_ladder_train_step_loss_matches_jax(f32_step):
    ref, got = f32_step
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= 1e-4 * ref["grad_norm"]


def test_ladder_train_step_gradient_leaves_match_jax(f32_step):
    """Every leaf behind the level-0 view pool agrees to 1e-4.  The leaves of
    ``branch_l0`` and of the stem it feeds are held to 1e-2: the ladder
    branch's set encoder normalizes over every segment (no ``seg_valid``),
    the thousands of empty ones included, whose size feature is 31.6 against
    0.5-1 on the others; the JAX package's float32 gradient through that
    batch norm carries 1e-3 of noise, the port's stays within 1e-5 of a
    float64 run (``test_pool_gradient_without_seg_valid_is_the_float64_one``)."""
    ref, got = f32_step
    grads, want = flat_leaves(got["grads"]), flat_leaves(ref["grads"])
    assert sorted(grads) == sorted(want)
    assert any(k.startswith("branch_l1/tower") for k in want)
    loose = ("branch_l0/", "stem/")
    bad = {k: rel_err(grads[k], want[k]) for k in want
           if not rel_err(grads[k], want[k])
           <= (1e-2 if k.startswith(loose) else 1e-4)}
    assert not bad, bad
    assert all(np.abs(g).max() > 0 for g in grads.values())


def test_pool_gradient_without_seg_valid_is_the_float64_one():
    """``GroupViewPool`` as the ladder branch calls it (training mode, no
    ``seg_valid``) on the ladder batch's view table: the port's float32
    parameter gradients against the same module in float64 over the plain
    segment reductions (1e-5), and against the JAX package (1e-2, see
    above)."""
    view = jax_ladder_batch()[0]["mappings"][0]["view"]
    s = len(view["point_ptr"]) - 1
    x_view = _rand((len(view["view_valid"]), 24), 2)
    weight = _rand((s, 16), 3)
    args = (view["view_feats"], view["point_id"], view["view_valid"], s)
    jp = jpool.GroupViewPool(16, num_groups=4)
    variables = jax_variables(jp, x_view, *args, seed=3, train=False,
                              ptr=view["point_ptr"])

    def loss(params):
        (out, _), _ = jp.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x_view, *args, train=True, ptr=view["point_ptr"],
            mutable=["batch_stats"])
        return (out * weight).sum()

    want = flat_leaves(jax.device_get(jax.grad(loss)(variables["params"])))
    tv = torch_batch(view)

    def port_grads(dtype, monkeypatch=None):
        pool = tpool.GroupViewPool(24, 16, num_groups=4).train()
        load_flax_variables(pool, variables)
        pool = pool.to(dtype)
        out, _ = pool(torch.from_numpy(x_view).to(dtype),
                      tv["view_feats"].to(dtype), tv["point_id"],
                      tv["view_valid"], s, ptr=tv["point_ptr"])
        (out * torch.from_numpy(weight).to(dtype)).sum().backward()
        return flat_leaves(to_flax_tree(pool, "grads"))

    got = port_grads(torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        # the wrapper takes float32 only; its plain version any float type
        mp.setattr(tseg, "segment_csr", tseg.segment_csr_plain)
        exact = port_grads(torch.float64)
    assert sorted(got) == sorted(want) == sorted(exact)
    assert max(rel_err(got[k], exact[k]) for k in exact) <= 1e-5
    assert max(rel_err(got[k], want[k]) for k in want) <= 1e-2


def test_ladder_bf16_step_stays_close_to_jax():
    ref, got = _step_both(f32=False)
    n = ref["n"]
    assert rel_err(got["logits"][:n], ref["logits"][:n]) <= 3e-2
    assert abs(got["loss"] - ref["loss"]) <= 2e-3 * abs(ref["loss"])
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= 5e-2 * ref["grad_norm"]


def test_one_state_dict_serves_flat_and_ladder_batches():
    """The same parameters answer a flat batch before and after a ladder
    forward, and the ladder form registers nothing of its own."""
    _, tspec = _specs(f32=False)
    spec0 = dataclasses.replace(tspec, branches=tspec.branches[:1])
    model = tsegm.MultimodalSeg(spec0, device="cpu", seed=4).eval()
    flat = torch_batch(jax_tiny_batch()[0])
    ladder = torch_batch(jax_ladder_batch()[0])
    keys = list(model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        a = model(flat)["logits"]
        out = model(ladder)
        b = model(flat)["logits"]
    assert torch.equal(a, b)
    assert torch.isfinite(out["logits"]).all() and out["x_seen"].any()
    assert list(model.state_dict()) == keys
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert len(list(model.parameters())) == len(
        {id(p) for p in model.parameters()})
    # the ladder form follows the model's mode and shares its modules
    form = model._ladder["branch_l0"]
    assert form.tower is model.branch_l0.tower and not form.training
    model.train()
    model(ladder)
    assert form.training and form.remat_tower == "convs"


def test_flax_tree_is_the_same_for_both_kinds_of_batch():
    """One flax tree initialised on the ladder batch loads into a model that
    then answers the flat batch as the JAX package does with that tree."""
    jspec, tspec = (dataclasses.replace(s, branches=s.branches[:1])
                    for s in _specs(f32=False))
    ladder, _, _ = jax_ladder_batch()
    flat, _ = jax_tiny_batch()
    jmodel = jsegm.MultimodalSeg(jspec)
    variables = jax_variables(jmodel, ladder, seed=8, train=False)
    on_flat = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), flat, train=False))
    assert sorted(flat_leaves(on_flat)) == sorted(flat_leaves(variables))
    tmodel = tsegm.MultimodalSeg(tspec, device="cpu", seed=None).eval()
    load_flax_variables(tmodel, variables)
    back = to_flax_tree(tmodel, "params")
    assert sorted(flat_leaves(back)) == sorted(flat_leaves(variables["params"]))
    for batch in (flat, ladder):
        ref = np.asarray(jmodel.apply(variables, batch, train=False)["logits"])
        with torch.no_grad():
            got = tmodel(torch_batch(batch))["logits"].numpy()
        n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
        assert rel_err(got[:n], ref[:n]) <= 3e-2


def test_branch_options_the_ladder_form_cannot_share_are_refused(
        monkeypatch):
    """A group pool with other than its default options, and the heuristic
    and QKV pools, have no ladder form in the JAX package: a ladder batch
    raises.  A ``max`` pool serves both kinds of batch: on the flat batch it
    equals the JAX model's (float32)."""
    _, tspec = _specs(f32=False)
    (_, b0), = tspec.branches[:1]
    ladder = torch_batch(jax_ladder_batch()[0])
    flat_np = jax_tiny_batch()[0]
    flat = torch_batch(flat_np)
    other = dataclasses.replace(tspec, branches=(
        (0, dataclasses.replace(b0, use_mod=True)),))
    model = tsegm.MultimodalSeg(other, device="cpu", seed=0).eval()
    with torch.no_grad():
        model(flat)
        with pytest.raises(ValueError, match="default options"):
            model(ladder)
    jspec, tspec32 = (dataclasses.replace(s, branches=(
        (0, dataclasses.replace(s.branches[0][1], view_pool="max")),))
        for s in _specs(f32=True))
    jmodel = jsegm.MultimodalSeg(jspec)
    variables = jax_variables(jmodel, flat_np, seed=9, train=False)
    model = tsegm.MultimodalSeg(tspec32, device="cpu", seed=None).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        out = model(ladder)
        assert torch.isfinite(out["logits"]).all()
        f32_sparse_convs(monkeypatch)
        with jt.f32_convs(), tt.f32_convs():
            ref = np.asarray(jmodel.apply(variables, flat_np,
                                          train=False)["logits"])
            got = model(flat)["logits"].numpy()
    n = int(np.asarray(flat_np["graph"]["levels"][0]["valid"]).sum())
    assert rel_err(got[:n], ref[:n]) <= 1e-4
    for pool in ("heuristic", "qkv"):
        model = tsegm.MultimodalSeg(dataclasses.replace(tspec, branches=(
            (0, dataclasses.replace(b0, view_pool=pool)),)), device="cpu")
        with torch.no_grad():
            model(flat)
            with pytest.raises(ValueError, match="no crop-ladder form"):
                model(ladder)


def test_eval_step_takes_a_ladder_batch():
    _, tspec = _specs(f32=False)
    model = tsegm.MultimodalSeg(tspec, device="cpu", seed=2)
    state = tstep.TrainState.create(model, topt.make_optimizer(
        topt.make_schedule("constant", 0.1)))
    res = tstep.make_eval_step(model)(state, torch_batch(jax_ladder_batch()[0]))
    assert not model.training and set(res) == {"logits", "preds", "x_seen"}
    assert torch.equal(res["preds"], res["logits"].argmax(-1))
