"""The view pools of the PyTorch port against the JAX package: the segment
arg-extrema (ties included), ``HeuristicPool``, ``MinMaxDiffSetFeat``,
``GroupViewPool`` with each set encoder, ``QKVViewPool`` over its
``use_mod_q`` x ``use_mod_k`` x ``dim_scaling`` options, and the whole
``UnimodalBranch`` with every view pool (eval, float32 tower).

The mappings are those of the JAX package's toy batch with three cameras,
so that points hold one to three views.  Float32 throughout; only summation
orders differ, so the pools agree within 1e-5 of the largest magnitude and
the arg-extrema exactly.  The number of segment reductions each pool makes
(what ``chip_smoke.py`` counts as kernel launches on the card) is held
here on the plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.toy import toy_batch
from deepviewagg_tpu.modules import branch as jbranch
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.modules import pooling as jpool
from deepviewagg_tpu.ops import segment as jseg
from deepviewagg_tpu_torch.modules import branch as tbranch
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import pooling as tpool
from deepviewagg_tpu_torch.ops import segment as tseg
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, flat_leaves,  # noqa: F401
                             jax_variables, rel_err, segment_case,
                             torch_batch)


@functools.lru_cache(maxsize=None)
def multi_view_batch():
    """The JAX package's toy batch seen by three cameras (points with one
    to three views), without meta."""
    batch, _, _ = toy_batch(n_samples=1, density=25.0, image_size=(64, 32),
                            n_cameras=3)
    return {k: v for k, v in batch.items() if k != "meta"}


def _pool_args(channels=24, seed=2):
    batch = multi_view_batch()
    m = batch["mappings"][0]
    s = len(batch["graph"]["levels"][0]["valid"]) + 1
    x_view = np.random.default_rng(seed).normal(
        size=(len(m["view_valid"]), channels)).astype(np.float32)
    seg_ok = np.arange(s) < s - 1
    return batch, m, s, x_view, seg_ok


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- segment_argmin / segment_argmax ----------------------------------------

@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("fn", ["segment_argmin", "segment_argmax"])
def test_segment_arg_matches_jax(fn, ties):
    x, ids, valid, ptr, s = segment_case(4, one_d=True, empty_tail=True)
    if ties:
        # three levels: most segments hold several elements at the extremum
        x = np.floor(np.abs(x) * 1.5).astype(np.float32)
    ref_arg, ref_ok = getattr(jseg, fn)(jnp.asarray(x), jnp.asarray(ids), s,
                                        jnp.asarray(valid))
    got_arg, got_ok = getattr(tseg, fn)(_t(x), _t(ids), s, _t(valid),
                                        _t(ptr))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(got_arg.numpy(), np.asarray(ref_arg))
    # the first valid index at the extremum, and empty segments read False
    pick = np.min if fn == "segment_argmin" else np.max
    for seg_id in range(s):
        rows = np.flatnonzero((ids == seg_id) & valid)
        assert bool(got_ok[seg_id]) == (len(rows) > 0)
        if len(rows):
            best = pick(x[rows])
            assert int(got_arg[seg_id]) == rows[x[rows] == best][0]
    if ties:
        assert sum((x[(ids == k) & valid] == pick(x[(ids == k) & valid])).sum()
                   > 1 for k in range(s) if ((ids == k) & valid).any()) > 10


# --- HeuristicPool, MinMaxDiffSetFeat, GroupViewPool --------------------------

def test_heuristic_pool_matches_jax():
    _, m, s, x_view, _ = _pool_args()
    ref = jpool.HeuristicPool().apply(
        {}, jnp.asarray(x_view), jnp.asarray(m["view_feats"]),
        jnp.asarray(m["point_id"]), jnp.asarray(m["view_valid"]), s,
        train=False)
    tm = torch_batch(m)
    got = tpool.HeuristicPool()(_t(x_view), tm["view_feats"], tm["point_id"],
                                tm["view_valid"], s, ptr=tm["point_ptr"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the closest view: a point's pooled row is one of its views' rows, and
    # the drop segment (no valid view) reads 0
    assert not got[-1].any()
    seen = tseg.segment_count(tm["point_id"], s, tm["view_valid"]) > 0
    assert (got[seen].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_min_max_diff_set_feat_matches_jax(train):
    _, m, s, _, seg_ok = _pool_args()
    args = (m["view_feats"], m["point_id"], m["view_valid"], s)
    jm = jpool.MinMaxDiffSetFeat(16)
    variables = jax_variables(jm, *args, seed=5, train=False,
                              ptr=m["point_ptr"])
    out = jm.apply(variables, *args, train=train, ptr=m["point_ptr"],
                   mutable=["batch_stats"] if train else False)
    ref = out[0] if train else out
    tm_ = tpool.MinMaxDiffSetFeat(8, 16).train(train)
    load_flax_variables(tm_, variables)
    tm = torch_batch(m)
    with torch.no_grad():
        got = tm_(tm["view_feats"], tm["point_id"], tm["view_valid"], s,
                  ptr=tm["point_ptr"])
    assert got.shape == ref.shape == (len(m["view_valid"]), 16)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    if train:
        assert rel_err(flat_leaves(to_flax_tree(tm_, "batch_stats"))[
            "mlp/MaskedBatchNorm_0/mean"], np.asarray(
                out[1]["batch_stats"]["mlp"]["MaskedBatchNorm_0"]["mean"])) \
            <= 1e-5


@pytest.mark.parametrize("set_encoder", ["deepset", "minmaxdiff", "mlp"])
def test_group_view_pool_with_each_set_encoder_matches_jax(set_encoder):
    _, m, s, x_view, seg_ok = _pool_args()
    args = (x_view, m["view_feats"], m["point_id"], m["view_valid"], s)
    jp = jpool.GroupViewPool(16, num_groups=4, set_encoder=set_encoder)
    variables = jax_variables(jp, *args, seed=3, train=False,
                              ptr=m["point_ptr"], seg_valid=seg_ok)
    ref, ref_attn = jp.apply(variables, *args, train=False,
                             ptr=m["point_ptr"], seg_valid=seg_ok)
    tp = tpool.GroupViewPool(24, 16, num_groups=4,
                             set_encoder=set_encoder).eval()
    load_flax_variables(tp, variables)
    tm = torch_batch(m)
    with torch.no_grad():
        got, attn = tp(_t(x_view), tm["view_feats"], tm["point_id"],
                       tm["view_valid"], s, ptr=tm["point_ptr"],
                       seg_valid=_t(seg_ok))
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    assert rel_err(attn.numpy(), np.asarray(ref_attn)) <= 1e-5


# --- QKVViewPool ------------------------------------------------------------

@pytest.mark.parametrize("dim_scaling", [True, False], ids=["dim", "nodim"])
@pytest.mark.parametrize("use_mod_k", [False, True], ids=["k", "modk"])
@pytest.mark.parametrize("use_mod_q", [False, True], ids=["q", "modq"])
def test_qkv_view_pool_matches_jax(use_mod_q, use_mod_k, dim_scaling):
    """Queries from the raw 4-channel point features, as at ``early``."""
    batch, m, s, x_view, seg_ok = _pool_args()
    x_main = batch["feats"]
    args = (x_main, x_view, m["view_feats"], m["point_id"], m["view_valid"],
            s)
    kw = dict(num_groups=4, use_mod_q=use_mod_q, use_mod_k=use_mod_k,
              dim_scaling=dim_scaling)
    jp = jpool.QKVViewPool(16, **kw)
    variables = jax_variables(jp, *args, seed=6, train=False,
                              ptr=m["point_ptr"], seg_valid=seg_ok)
    ref, ref_attn = jp.apply(variables, *args, train=False,
                             ptr=m["point_ptr"], seg_valid=seg_ok)
    tp = tpool.QKVViewPool(x_main.shape[1], 24, 16, **kw).eval()
    load_flax_variables(tp, variables)
    assert hasattr(tp, "e_mix_q") == use_mod_q
    assert hasattr(tp, "e_mix_k") == use_mod_k
    tm = torch_batch(m)
    with torch.no_grad():
        got, attn = tp(_t(x_main), _t(x_view), tm["view_feats"],
                       tm["point_id"], tm["view_valid"], s,
                       ptr=tm["point_ptr"], seg_valid=_t(seg_ok))
    assert got.shape == ref.shape == (s, 16)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    assert rel_err(attn.numpy(), np.asarray(ref_attn)) <= 1e-5


def test_qkv_view_pool_gradients_match_jax():
    """Training mode (masked batch norms on batch statistics): the gradient
    of a weighted sum of the pooled features, every parameter leaf within
    1e-4 of its largest magnitude."""
    batch, m, s, x_view, seg_ok = _pool_args()
    x_main = batch["feats"]
    args = (x_main, x_view, m["view_feats"], m["point_id"], m["view_valid"],
            s)
    kw = dict(num_groups=2, use_mod_q=True, use_mod_k=True)
    jp = jpool.QKVViewPool(16, **kw)
    variables = jax_variables(jp, *args, seed=7, train=False,
                              ptr=m["point_ptr"], seg_valid=seg_ok)
    cot = np.random.default_rng(8).normal(size=(s, 16)).astype(np.float32)

    def loss(params):
        out, _ = jp.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, *args,
                          train=True, ptr=m["point_ptr"], seg_valid=seg_ok,
                          mutable=["batch_stats"])
        return jnp.sum(out[0] * cot)

    ref = jax.device_get(jax.grad(loss)(variables["params"]))
    tp = tpool.QKVViewPool(x_main.shape[1], 24, 16, **kw).train()
    load_flax_variables(tp, variables)
    tm = torch_batch(m)
    got, _ = tp(_t(x_main), _t(x_view), tm["view_feats"], tm["point_id"],
                tm["view_valid"], s, ptr=tm["point_ptr"],
                seg_valid=_t(seg_ok))
    (got * _t(cot)).sum().backward()
    grads, ref = flat_leaves(to_flax_tree(tp, "grads")), flat_leaves(ref)
    assert sorted(grads) == sorted(ref)
    bad = {k: rel_err(grads[k], ref[k]) for k in ref
           if not rel_err(grads[k], ref[k]) <= 1e-4}
    assert not bad, bad


# --- UnimodalBranch with every view pool -------------------------------------

_BRANCH_POOLS = ["group", "qkv", "heuristic", "max", "mean"]


def _branch_pair(view_pool, set_encoder="deepset"):
    batch = multi_view_batch()
    m = batch["mappings"][0]
    images = batch["images"]
    ref_size = tuple(images.shape[1:3])
    x3d = batch["feats"]
    kw = dict(out_channels=32, view_pool=view_pool, num_groups=4,
              tower_bf16=False, fusion_mode="concatenation",
              set_encoder=set_encoder, keep_last_view=True)
    jb = jbranch.UnimodalBranch(
        tower=functools.partial(jt.ResNet18, out_level=1, name="tower"), **kw)
    variables = jax_variables(jb, x3d, images, m, ref_size, seed=4,
                              train=False)
    kw.pop("out_channels")
    tb = tbranch.UnimodalBranch(tt.ResNet18(out_level=1), 64, x3d.shape[1],
                                32, **kw).eval()
    load_flax_variables(tb, variables)
    return batch, jb, variables, tb


@pytest.mark.parametrize("view_pool", _BRANCH_POOLS)
def test_unimodal_branch_with_each_view_pool_matches_jax(view_pool):
    batch, jb, variables, tb = _branch_pair(view_pool)
    m, images = batch["mappings"][0], batch["images"]
    ref_size = tuple(images.shape[1:3])
    with jt.f32_convs():
        ref, ref_seen, ref_ex = jb.apply(variables, batch["feats"], images, m,
                                         ref_size, train=False)
    tbatch = torch_batch(batch)
    with torch.no_grad(), tt.f32_convs():
        got, seen, ex = tb(tbatch["feats"], tbatch["images"],
                           tbatch["mappings"][0], ref_size)
    width = 32 if view_pool in ("group", "qkv") else 64
    assert got.shape == ref.shape == (len(seen), 4 + width)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    np.testing.assert_array_equal(seen.numpy(), np.asarray(ref_seen))
    assert sorted(ex) == sorted(ref_ex) == ["attention", "view_point_id",
                                            "view_valid", "x_view"]
    assert rel_err(ex["x_view"].numpy(), np.asarray(ref_ex["x_view"])) <= 1e-5
    if view_pool in ("group", "qkv"):
        assert rel_err(ex["attention"].numpy(),
                       np.asarray(ref_ex["attention"])) <= 1e-5
    else:
        assert ex["attention"] is None and ref_ex["attention"] is None


def _count_calls(monkeypatch):
    calls = {"forward": [], "backward": []}
    fwd, bwd = tseg.segment_csr_plain, tseg.segment_csr_bwd_plain
    monkeypatch.setattr(tseg, "segment_csr_plain", lambda x, p, v, r: (
        calls["forward"].append(r), fwd(x, p, v, r))[1])
    monkeypatch.setattr(tseg, "segment_csr_bwd_plain", lambda *a, **k: (
        calls["backward"].append(a[5]), bwd(*a, **k))[1])
    return calls


# segment reductions of one branch's forward and backward: the atomic pool
# and the view count, then the pool's own (QKV: the key encoder's max, the
# compatibilities' max, the softmax sum, the weighted sum; min-max-diff: its
# min and max of the map features, which take no gradient)
_LAUNCHES = {("group", "deepset"): (6, 5), ("group", "minmaxdiff"): (7, 4),
             ("group", "mlp"): (5, 4), ("qkv", "deepset"): (6, 5),
             ("heuristic", "deepset"): (3, 1), ("max", "deepset"): (3, 2),
             ("mean", "deepset"): (3, 2)}


@pytest.mark.parametrize("view_pool,set_encoder", sorted(_LAUNCHES))
def test_segment_reductions_per_branch(monkeypatch, view_pool, set_encoder):
    batch, _, _, tb = _branch_pair(view_pool, set_encoder)
    tb.train()
    tbatch = torch_batch(batch)
    calls = _count_calls(monkeypatch)
    out, _, ex = tb(tbatch["feats"], tbatch["images"], tbatch["mappings"][0],
                    tuple(tbatch["images"].shape[1:3]))
    (out.square().sum() + ex["x_view"].sum()).backward()
    assert (len(calls["forward"]), len(calls["backward"])) == \
        _LAUNCHES[view_pool, set_encoder]
