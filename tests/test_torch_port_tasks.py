"""The port's task heads, losses and steps against the JAX package's, on the
same numpy batches from the same converted flax variables:
``SparseConv3dCls`` (classification), ``VoteNetDet`` + ``votenet_loss``
(detection), ``PanopticSeg`` + ``instance_loss`` (panoptic),
``RegistrationNet`` + ``hardest_contrastive`` / ``kabsch`` /
``mutual_nearest`` (registration), the host numpy metrics, and each task's
train step (``TaskTrainer`` and ``cli.train_task``:
``test_torch_port_task_trainer.py``).

Bounds.  With float32 sparse-conv operands (``f32_sparse_convs``) the two
packages differ in summation order only: eval-mode outputs within 1e-4 of
the largest magnitude, the step's loss within 1e-5 relative and every
gradient leaf, updated parameter and running statistic within 1e-4 (ROADMAP
C's bounds for a model).  A gradient leaf that is zero in exact arithmetic
is held absolutely instead, to 1e-6 of the largest gradient: ``vote_feat``'s
bias shifts every row of the proposal MLP's input alike, which its first
batch norm removes, so both packages return rounding noise of about 1e-8
there.  With the production bf16 operands the step is held at its loss
(2e-3) and gradient norm (5e-2), as ``test_torch_port_train_step.py`` holds
the segmentation step (1.2e-4 and 7.9e-3 measured on the registration
pair, the widest gaps here).  The classification Dropout(0.3) is switched
off on both sides for these comparisons (no generator in the port, flax's
``Dropout`` replaced by the identity in the JAX module): the two packages'
random streams differ.  The steps take plain SGD here so that an update is
the gradient times the learning rate; Adam, as ``TaskTrainer`` runs it, is
held over two batches of the detection task in
``test_torch_port_task_trainer.py``.

The numpy-only functions (``panoptic_quality``, ``cluster_instances``, the
detection metrics) give the same results bit for bit.
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepviewagg_tpu.data.collate import Bucket as JBucket
from deepviewagg_tpu.data.collate import device_view as j_device_view
from deepviewagg_tpu.data.datasets import tasks as JT
from deepviewagg_tpu.metrics import detection as jmet
from deepviewagg_tpu.models import classification as jcls
from deepviewagg_tpu.models import detection as jdet
from deepviewagg_tpu.models import panoptic as jpan
from deepviewagg_tpu.models import registration as jreg
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import task_steps as JS
from deepviewagg_tpu.train.step import TrainState as JState
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.metrics import detection as tmet
from deepviewagg_tpu_torch.models import classification as tcls
from deepviewagg_tpu_torch.models import detection as tdet
from deepviewagg_tpu_torch.models import panoptic as tpan
from deepviewagg_tpu_torch.models import registration as treg
from deepviewagg_tpu_torch.ops import segment as tseg
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import task_steps as TS
from deepviewagg_tpu_torch.train.step import TrainState as TState
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             flat_leaves, jax_variables, rel_err)

OUT_RTOL = 1e-4
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
ZERO_LEAF = 1e-6          # of the largest gradient, for exact-zero leaves
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_NORM_RTOL = 5e-2
LR = 0.05
SGD = dict(optimizer="sgd", momentum=0.0, weight_decay=0.0, grad_clip=10.0)
DET_SA = ((16, 32), (32, 64))


# --- the four tasks' batches and models -------------------------------------

def _cls_case():
    ds = JT.make_classification_dataset(None, n_points=256, voxel_size=0.1)
    batch = j_device_view(JT.collate_classification(
        [ds[i] for i in range(2)],
        JBucket(level_caps=[512, 512, 256, 128, 64], num_batches=2)))
    return (batch, {k: v for k, v in batch.items() if k != "cls_label"},
            jcls.SparseConv3dCls(num_classes=8, backbone="Res16UNetTest",
                                 num_batches=2),
            tcls.SparseConv3dCls(8, "Res16UNetTest", 2, device="cpu",
                                 seed=None),
            JS.make_classification_step, TS.make_classification_step)


def _det_case():
    batch = JT.make_detection_dataset(None, n_points=600, n_proposals=16)[0]
    return (batch, {k: v for k, v in batch.items() if k != "gt_boxes"},
            jdet.VoteNetDet(num_classes=2, sa_channels=DET_SA),
            tdet.VoteNetDet(2, sa_channels=DET_SA, device="cpu", seed=None),
            JS.make_detection_step, TS.make_detection_step)


def _pan_case():
    ds = JT.make_panoptic_dataset(None, voxel_size=0.15)
    batch = j_device_view(JT.collate_panoptic(
        [ds[i] for i in range(2)],
        JBucket(level_caps=[12288, 4096, 2048, 1024, 512], num_batches=2)))
    return (batch, {k: v for k, v in batch.items() if k != "instance"},
            jpan.PanopticSeg(num_classes=4, backbone="Res16UNetTest"),
            tpan.PanopticSeg(4, "Res16UNetTest", device="cpu", seed=None),
            lambda m: JS.make_panoptic_step(m, 64),
            lambda m: TS.make_panoptic_step(m, 64))


def _reg_case():
    ds = JT.make_registration_dataset(None, n_points=512, voxel_size=0.15)
    batch = JT.collate_registration(
        ds[0], JBucket(level_caps=[512, 512, 256, 128, 64], num_batches=1))
    return (batch, batch["a"],
            jreg.RegistrationNet(descriptor_dim=16, backbone="Res16UNetTest"),
            treg.RegistrationNet(16, "Res16UNetTest", device="cpu", seed=None),
            JS.make_registration_step, TS.make_registration_step)


CASES = {"classification": _cls_case, "detection": _det_case,
         "panoptic": _pan_case, "registration": _reg_case}


def _no_flax_dropout(monkeypatch):
    proxy = types.SimpleNamespace(**{k: getattr(flax.linen, k)
                                     for k in dir(flax.linen)
                                     if not k.startswith("__")})
    proxy.Dropout = lambda rate, deterministic=None: (lambda h: h)
    monkeypatch.setattr(jcls, "nn", proxy)


def _run(task, f32: bool):
    """One eval forward and one SGD train step of both packages from the
    same variables: outputs, step metrics, the step's gradients (the JAX
    ones read off a leading optax transformation that keeps them as its
    state), the parameters and running statistics after it."""
    with pytest.MonkeyPatch.context() as mp:
        if f32:
            f32_sparse_convs(mp)
        _no_flax_dropout(mp)
        batch, view, jmodel, tmodel, jmake, tmake = CASES[task]()
        variables = jax_variables(jmodel, view, train=False, seed=1)
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, s, p=None: (u, u))
        tx = optax.chain(keep, jopt.make_optimizer(
            jopt.make_schedule("constant", LR), **SGD))
        state = JState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
        j_eval = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, view)
        state, j_metrics = jax.jit(jmake(jmodel))(state, batch,
                                                  jax.random.PRNGKey(0))
        want = {"eval": jax.device_get(j_eval),
                "metrics": {k: np.asarray(v) for k, v in j_metrics.items()},
                "grads": jax.device_get(state.opt_state[0]),
                "params": jax.device_get(state.params),
                "stats": jax.device_get(state.batch_stats)}

        load_flax_variables(tmodel, variables)
        tb = batch_to_torch(batch, "cpu")
        tview = tb["a"] if task == "registration" else tb
        tmodel.eval()
        with torch.no_grad():
            t_eval = tmodel(tview)
        tstate = TState.create(tmodel, topt.make_optimizer(
            topt.make_schedule("constant", LR), **SGD))
        tstate, t_metrics = tmake(tmodel)(tstate, tb, None)
        for p in tmodel.parameters():      # an unused head: no gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        got = {"eval": (t_eval.numpy() if torch.is_tensor(t_eval) else
                        {k: v.numpy() for k, v in t_eval.items()}),
               "metrics": {k: v.numpy() for k, v in t_metrics.items()},
               "grads": to_flax_tree(tmodel, "grads"),
               "params": to_flax_tree(tmodel, "params"),
               "stats": to_flax_tree(tmodel, "batch_stats"),
               "step": tstate.step, "batch": tb, "model": tmodel}
    return got, want


@pytest.fixture(scope="module", params=list(CASES))
def f32_run(request):
    return request.param, _run(request.param, f32=True)


def _valid_rows(task, got):
    tb = got["batch"]
    if task == "classification":
        return slice(None)
    if task == "detection":
        return tb["det_clusters"]["center_valid"].numpy()
    view = tb["a"] if task == "registration" else tb
    return view["graph"]["levels"][0]["valid"].numpy()


def test_eval_forward_matches_jax(f32_run):
    task, (got, want) = f32_run
    rows = _valid_rows(task, got)
    if task == "registration":
        assert got["eval"].shape == want["eval"].shape
        assert rel_err(got["eval"][rows], want["eval"][rows]) <= OUT_RTOL
        return
    assert sorted(got["eval"]) == sorted(want["eval"])
    for key, w in want["eval"].items():
        g = got["eval"][key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
        elif task == "detection" and g.shape[0] != len(rows):
            assert rel_err(g, w) <= OUT_RTOL, key    # the seed rows
        else:
            assert rel_err(g[rows], w[rows]) <= OUT_RTOL, key


def test_step_metrics_match_jax(f32_run):
    task, (got, want) = f32_run
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    assert got["step"] == 1
    for key, w in want["metrics"].items():
        g = got["metrics"][key]
        if key == "preds":
            valid = got["batch"]["graph"]["levels"][0]["valid"].numpy()
            assert (g[valid] == w[valid]).mean() >= 0.999
        elif key in ("loss", "loss_sem", "loss_offset", "loss_vote",
                     "loss_obj", "loss_box", "pair_dist"):
            assert abs(float(g) - float(w)) <= LOSS_RTOL * max(
                abs(float(w)), 1e-6), key
        else:
            assert abs(float(g) - float(w)) <= LEAF_RTOL * max(
                abs(float(w)), 1e-6), key


def _leaf_errs(got, want, floor=0.0):
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()
                     / max(np.abs(want[k]).max(), floor, 1e-30))
            for k in want}


def test_step_gradients_match_jax(f32_run):
    task, (got, want) = f32_run
    gmax = max(np.abs(v).max() for v in flat_leaves(want["grads"]).values())
    errs = _leaf_errs(got["grads"], want["grads"],
                      floor=ZERO_LEAF / LEAF_RTOL * gmax)
    assert max(errs.values()) <= LEAF_RTOL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:3]


def test_step_updates_and_running_statistics_match_jax(f32_run):
    task, (got, want) = f32_run
    for key in ("params", "stats"):
        errs = _leaf_errs(got[key], want[key])
        assert max(errs.values()) <= LEAF_RTOL, (key, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3])


@pytest.mark.parametrize("task", ["classification", "panoptic",
                                  "registration"])
def test_bf16_step_stays_close_to_jax(task):
    got, want = _run(task, f32=False)
    for key, rtol in (("loss", BF16_LOSS_RTOL),
                      ("grad_norm", BF16_GRAD_NORM_RTOL)):
        g, w = float(got["metrics"][key]), float(want["metrics"][key])
        assert abs(g - w) <= rtol * abs(w), (key, g, w)


def test_classification_pool_runs_the_segment_path(monkeypatch):
    """The pools reduce the coarsest level's ``batch_idx`` (sorted, padding
    in the last slot) through ``segment_csr``: on CPU tensors its plain
    version, three forward calls (the mean's sum and count, the max) and
    two backward calls (the count takes no gradient); the pooled values
    equal a direct masked mean / max."""
    batch, view, _, tmodel, _, _ = _cls_case()
    tmodel = tcls.SparseConv3dCls(8, "Res16UNetTest", 2, device="cpu",
                                  seed=0)
    lvl = view["graph"]["levels"][-1]
    ids = lvl["batch_idx"]
    assert (np.diff(ids) >= 0).all() and (ids[~lvl["valid"]] == 2).all()
    fwd, bwd = [], []
    plain, plain_bwd = tseg.segment_csr_plain, tseg.segment_csr_bwd_plain
    monkeypatch.setattr(tseg, "segment_csr_plain", lambda x, p, v, r: (
        fwd.append((x.detach().clone(), r)) or plain(x, p, v, r)))
    monkeypatch.setattr(tseg, "segment_csr_bwd_plain", lambda *a, **k: (
        bwd.append(a[5]) or plain_bwd(*a, **k)))
    before = dict(tseg.LAUNCHES)
    tb = batch_to_torch(view, "cpu")
    tmodel.train()
    tmodel(tb)["logits"].sum().backward()
    assert tseg.LAUNCHES == before
    assert [r for _, r in fwd] == ["sum", "sum", "max"]
    assert sorted(bwd) == ["max", "sum"]
    x = fwd[0][0]
    valid = torch.from_numpy(lvl["valid"])
    tids = torch.from_numpy(ids).long()
    for b in range(2):
        rows = x[(tids == b) & valid]
        got = tcls.sparse_global_pool(x, torch.from_numpy(ids), 3,
                                      valid=valid, reduce="max")[b]
        assert torch.equal(got, rows.amax(0))
        got = tcls.sparse_global_pool(x, torch.from_numpy(ids), 3,
                                      valid=valid, reduce="mean")[b]
        assert torch.allclose(got, rows.mean(0), rtol=1e-6, atol=1e-7)


def test_sparse_global_pool_matches_jax():
    from deepviewagg_tpu.ops.sparse_conv import sparse_global_pool as jpool

    rng = np.random.default_rng(4)
    ids = np.sort(rng.integers(0, 4, 300)).astype(np.int32)
    valid = rng.uniform(size=300) > 0.2
    ids[-20:] = 4
    valid[-20:] = False
    x = rng.normal(size=(300, 16)).astype(np.float32)
    for reduce in ("mean", "max", "sum"):
        want = np.asarray(jpool(x, ids, 5, valid=valid, reduce=reduce))
        got = tcls.sparse_global_pool(torch.from_numpy(x),
                                      torch.from_numpy(ids), 5,
                                      valid=torch.from_numpy(valid),
                                      reduce=reduce).numpy()
        assert rel_err(got, want) <= 1e-6, reduce


def test_classification_dropout_follows_the_generator():
    batch, view, _, _, _, _ = _cls_case()
    tb = batch_to_torch(view, "cpu")
    model = tcls.SparseConv3dCls(8, "Res16UNetTest", 2, device="cpu", seed=0)

    def logits(train, seed=None):
        model.train(train)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            # a copy of the running statistics: each train pass moves them
            state = {k: v.clone() for k, v in model.state_dict().items()}
            out = model(tb, generator=gen)["logits"]
            model.load_state_dict(state)
        return out

    plain = logits(True)
    assert not torch.equal(logits(True, 1), plain)
    assert torch.equal(logits(True, 1), logits(True, 1))
    assert not torch.equal(logits(True, 1), logits(True, 2))
    # eval mode never draws
    assert torch.equal(logits(False, 1), logits(False))


# --- losses alone -----------------------------------------------------------

def test_votenet_loss_matches_jax():
    rng = np.random.default_rng(9)
    out = {"seed_pos": rng.uniform(0, 4, (64, 3)).astype(np.float32),
           "vote_pos": rng.uniform(0, 4, (64, 3)).astype(np.float32),
           "seed_valid": rng.uniform(size=64) > 0.1,
           "center": rng.uniform(0, 4, (16, 3)).astype(np.float32),
           "size": rng.uniform(0.2, 1.0, (16, 3)).astype(np.float32),
           "objectness": rng.normal(size=(16, 2)).astype(np.float32),
           "cls_logits": rng.normal(size=(16, 3)).astype(np.float32),
           "proposal_valid": rng.uniform(size=16) > 0.2}
    boxes = np.zeros((6, 6), np.float32)
    boxes[:4, :3] = rng.uniform(0.5, 3.5, (4, 3))
    boxes[:4, 3:] = rng.uniform(0.8, 2.0, (4, 3))
    classes = rng.integers(0, 3, 6)
    # proposals near the boxes' centres (positives) and seeds inside them
    out["center"][:8] = boxes[np.arange(8) % 4, :3] + rng.normal(
        0, 0.2, (8, 3))
    out["seed_pos"][:16] = boxes[np.arange(16) % 4, :3] + rng.normal(
        0, 0.1, (16, 3))
    diff = ("vote_pos", "center", "size", "objectness", "cls_logits")
    for gt_classes in (None, classes):
        def jloss(d):
            return jdet.votenet_loss({**out, **d}, boxes, gt_classes)

        (j_total, j_parts), j_grads = jax.value_and_grad(
            jloss, has_aux=True)({k: out[k] for k in diff})
        t_in = {k: torch.from_numpy(v).requires_grad_() if k in diff
                else torch.from_numpy(v) for k, v in out.items()}
        t_total, t_parts = tdet.votenet_loss(t_in, boxes, gt_classes)
        t_total.backward()
        assert abs(float(t_total) - float(j_total)) <= 1e-6 * abs(
            float(j_total))
        for k in j_parts:
            assert abs(float(t_parts[k]) - float(j_parts[k])) <= 1e-6 * max(
                abs(float(j_parts[k])), 1e-6), k
        for k in diff:
            if t_in[k].grad is None:        # no class loss: no class grads
                t_in[k].grad = torch.zeros_like(t_in[k])
            np.testing.assert_allclose(t_in[k].grad.numpy(),
                                       np.asarray(j_grads[k]), rtol=1e-6,
                                       atol=1e-7)
    assert float(j_parts["box"]) > 0    # some proposals are positive


def test_instance_loss_matches_jax():
    rng = np.random.default_rng(10)
    n = 500
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.integers(-1, 7, n).astype(np.int32)   # unsorted, -1 = stuff
    valid = rng.uniform(size=n) > 0.1
    off = rng.normal(size=(n, 3)).astype(np.float32)
    for kw in (dict(num_instances=7, valid=valid), dict(num_instances=5),
               dict(num_instances=64, valid=valid)):
        jv, jg = jax.value_and_grad(lambda o: jpan.instance_loss(
            o, pos, ids, kw["num_instances"], kw.get("valid")))(off)
        t_off = torch.from_numpy(off).requires_grad_()
        tv = tpan.instance_loss(
            t_off, torch.from_numpy(pos), torch.from_numpy(ids),
            kw["num_instances"], None if "valid" not in kw
            else torch.from_numpy(kw["valid"]))
        tv.backward()
        assert abs(float(tv) - float(jv)) <= 1e-6 * float(jv), kw
        np.testing.assert_allclose(t_off.grad.numpy(), np.asarray(jg),
                                   atol=1e-8)
    # host ids: the table defaults to max(ids) + 1
    want = float(jpan.instance_loss(off, pos, ids))
    got = float(tpan.instance_loss(torch.from_numpy(off), pos, ids))
    assert abs(got - want) <= 1e-6 * want
    assert float(tpan.instance_loss(torch.from_numpy(off), pos,
                                    np.full(n, -1, np.int32))) == 0.0


def test_hardest_contrastive_matches_jax():
    rng = np.random.default_rng(11)

    def unit(n):
        d = rng.normal(size=(n, 16)).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    da, db = unit(300), unit(320)
    pairs = np.stack([rng.permutation(300)[:64], rng.permutation(320)[:64]],
                     1).astype(np.int32)
    pairs[:5, 1] = pairs[:5, 0]          # identical descriptors for some
    db[pairs[:5, 1]] = da[pairs[:5, 0]]
    valid_b = np.ones(320, bool)
    valid_b[-30:] = False
    for vb in (None, valid_b):
        jv, (jga, jgb) = jax.value_and_grad(
            lambda a, b: jreg.hardest_contrastive(a, b, pairs, valid_b=vb),
            argnums=(0, 1))(da, db)
        ta = torch.from_numpy(da).requires_grad_()
        tb = torch.from_numpy(db).requires_grad_()
        tv = treg.hardest_contrastive(
            ta, tb, torch.from_numpy(pairs),
            valid_b=None if vb is None else torch.from_numpy(vb))
        tv.backward()
        assert abs(float(tv) - float(jv)) <= 1e-6 * float(jv)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga),
                                   atol=1e-7)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb),
                                   atol=1e-7)
        assert np.isfinite(ta.grad.numpy()).all()


def test_kabsch_matches_jax():
    rng = np.random.default_rng(12)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    src = rng.normal(size=(200, 3)).astype(np.float32)
    dst = (src @ q.T + rng.normal(size=3)
           + rng.normal(0, 0.01, (200, 3))).astype(np.float32)
    w = rng.uniform(0, 1, 200).astype(np.float32)
    w[:20] = 0.0
    dst[:20] += 5.0
    for weights in (None, w):
        jr, jt = jreg.kabsch(src, dst, weights)
        tr, tt = treg.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                             None if weights is None
                             else torch.from_numpy(weights))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-5)
        assert abs(float(torch.linalg.det(tr)) - 1.0) < 1e-5
    # the weighted solve ignores the moved rows: the true rotation
    np.testing.assert_allclose(tr.numpy(), q, atol=1e-2)


def test_mutual_nearest_matches_jax():
    rng = np.random.default_rng(13)
    d = rng.normal(size=(80, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(80)
    other = d[perm] + rng.normal(0, 0.3, (80, 16)).astype(np.float32)
    va, vb = rng.uniform(size=80) > 0.2, rng.uniform(size=80) > 0.2
    for kw in ({}, {"valid_a": va, "valid_b": vb}):
        want = jreg.mutual_nearest(jnp.asarray(d), jnp.asarray(other),
                                   **{k: jnp.asarray(v)
                                      for k, v in kw.items()})
        got = treg.mutual_nearest(torch.from_numpy(d),
                                  torch.from_numpy(other),
                                  **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the host numpy metrics -------------------------------------------------

def test_panoptic_quality_and_clusters_are_the_jax_results():
    rng = np.random.default_rng(14)
    blobs = [rng.normal(0, 0.1, (60, 3)) + c for c in
             ([0, 0, 0], [4, 0, 0], [0, 4, 0])]
    wall = rng.normal(0, 0.1, (50, 3)) + [2, 2, 0]
    pos = np.concatenate(blobs + [wall]).astype(np.float32)
    sem = np.array([3] * 120 + [2] * 60 + [1] * 50)
    offsets = rng.normal(0, 0.05, pos.shape).astype(np.float32)
    kw = dict(thing_classes=[2, 3], cell=0.4, min_points=5)
    got = tpan.cluster_instances(pos, offsets, sem, **kw)
    want = jpan.cluster_instances(pos, offsets, sem, **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(np.unique(got[got >= 0])) == 3
    gt_inst = np.repeat(np.arange(4), [60, 60, 60, 50]).astype(np.int32)
    gt_inst[-50:] = -1
    for pred_sem in (sem, np.where(rng.uniform(size=len(sem)) < 0.1, 1, sem)):
        args = (pred_sem, got, sem, gt_inst)
        assert (tpan.panoptic_quality(*args, num_classes=4,
                                      thing_classes=[2, 3])
                == jpan.panoptic_quality(*args, num_classes=4,
                                         thing_classes=[2, 3]))


def test_detection_metrics_are_the_jax_results():
    rng = np.random.default_rng(15)

    def boxes(n):
        b = np.zeros((n, 6))
        b[:, :3] = rng.uniform(0, 5, (n, 3))
        b[:, 3:] = rng.uniform(0.3, 1.5, (n, 3))
        return b

    a, b = boxes(12), boxes(9)
    assert tmet.box_iou_3d(a, b).tobytes() == jmet.box_iou_3d(a, b).tobytes()
    gt = boxes(6)
    pred = np.concatenate([gt + rng.normal(0, 0.1, gt.shape), boxes(5)])
    scores = rng.uniform(size=len(pred))
    for th in (0.25, 0.5):
        assert (tmet.average_precision(pred, scores, gt, th)
                == jmet.average_precision(pred, scores, gt, th))
    preds = [{"boxes": pred, "scores": scores,
              "classes": rng.integers(0, 3, len(pred))} for _ in range(2)]
    gts = [{"boxes": gt, "classes": rng.integers(0, 3, len(gt))}
           for _ in range(2)]
    for th in (0.25, 0.5):
        assert (tmet.mean_average_precision(preds, gts, 3, th)
                == jmet.mean_average_precision(preds, gts, 3, th))
    assert tmet.average_precision(np.zeros((0, 6)), np.zeros(0),
                                  np.zeros((0, 6))) == 1.0
