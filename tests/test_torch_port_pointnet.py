"""The port's PointNet (``nn/pointnet.py``) against the JAX package's, on a
two-sample batch collated by the JAX package, from the same converted flax
variables: ``TNet`` alone, ``PointNetSeg`` and ``PointNetCls`` whole, the
global max pools (segment maxima over ``batch_idx``) and the classifier's
dropout.

Bounds.  Float32 throughout: 1e-5 of the largest magnitude for a layer,
1e-4 for a model (ROADMAP C); the segment maxima and their gradients are
bit-exact.  The models' train-mode gradient is discontinuous at float32
rounding: on this batch four ReLU gates of the 794 x (64 .. 1024) hidden
rows sit within 2e-6 of zero (pre-activations of 4.3e-7 .. 2.4e-6), and
the two packages' summation orders open them differently, which moves
gradient leaves by up to 1% (ROADMAP C, "Limits on parity").  So the
train-mode comparison imposes the port's ReLU gates on the JAX module (its
``nn.relu`` replaced by a ``where`` on the port's recorded signs, in call
order); the outputs move by less than the pre-activations, and every
gradient leaf is then held at 1e-4.  The one exact-zero leaf,
``encoder/MaskedBatchNorm_4/bias`` of the segmentation net (its shift
reaches the head as a constant column, which the head's first batch norm
removes), is held absolutely at 1e-6 of the largest gradient: both
packages return rounding noise of about 1e-9 there.  The T-Nets' last
layers start at zero in both packages (flax's ``zeros`` initializers);
here their kernels are drawn at 1e-2 of the other kernels' scale, near
that identity, so that the transformed features keep their scale.
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepviewagg_tpu.data.collate import Bucket, Sample, collate, device_view
from deepviewagg_tpu.nn import pointnet as jpt
from deepviewagg_tpu.ops import segment as jseg
from deepviewagg_tpu.ops import voxel as jvoxel
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.modules import branch
from deepviewagg_tpu_torch.nn import pointnet as tpt
from deepviewagg_tpu_torch.ops import segment as tseg
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_backbones import (assert_layer_close, assert_same_tree,
                                  layer_runs, leaf_errs, masked_ce_jax,
                                  masked_ce_torch)
from torch_port_util import (_torch_threads, flat_leaves,  # noqa: F401
                             jax_variables, rel_err)

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
ZERO_LEAF_ATOL = 1e-6          # of the largest gradient
TNET_LAST_SCALE = 1e-2
SAMPLES, CLASSES = 2, 5


def _batch():
    """Two samples of 400 random points each, voxelized at 0.1 and collated
    by the JAX package (``tests/test_stragglers.py::_pn_batch``'s recipe),
    as numpy."""
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(SAMPLES):
        pos = rng.uniform(0, 3, (400, 3)).astype(np.float32)
        rgb = rng.uniform(0, 1, (400, 3)).astype(np.float32)
        g = jvoxel.grid_sample(pos, 0.1, feats=rgb, labels=rng.integers(
            0, CLASSES, 400).astype(np.int32))
        samples.append(Sample(
            coords=g["coords"][:, 1:], labels=g["labels"], pos=g["pos"],
            feats=np.concatenate([g["feats"], np.ones((len(g["pos"]), 1),
                                                      np.float32)], 1)))
    batch = device_view(collate(samples, Bucket(level_caps=[1024] * 5,
                                                num_batches=SAMPLES),
                                conv0_kernel=3))
    return jax.tree_util.tree_map(np.asarray, batch)


BATCH = _batch()
LEVEL = BATCH["graph"]["levels"][0]
VALID = LEVEL["valid"]


def _variables(jmodel):
    variables = jax_variables(jmodel, BATCH, train=False, seed=2)
    for t in ("stn3", "stnf"):
        leaf = variables["params"]["encoder"][t]["Dense_5"]
        leaf["kernel"] = leaf["kernel"] * np.float32(TNET_LAST_SCALE)
    return variables


def _recording_relu(monkeypatch, masks):
    """The port's ``F.relu`` in ``nn/pointnet.py`` records its gates."""
    proxy = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                     if not k.startswith("__")})

    def relu(x, inplace=False):
        masks.append((x > 0).detach().numpy().copy())
        return F.relu(x)

    proxy.relu = relu
    monkeypatch.setattr(tpt, "F", proxy)


def _imposed_relu(monkeypatch, masks):
    """The JAX module's ``nn.relu`` opens the recorded gates, in order."""
    proxy = types.SimpleNamespace(**{k: getattr(flax.linen, k)
                                     for k in dir(flax.linen)
                                     if not k.startswith("__")})
    order = iter(masks)
    proxy.relu = lambda x: jnp.where(next(order), x, 0.0)
    monkeypatch.setattr(jpt, "nn", proxy)


def _runs(jmodel, tmodel, labels, loss_valid):
    """Eval-mode logits of both; then the port's train-mode pass (gates
    recorded) and the JAX one with those gates: logits, loss, gradients,
    running statistics."""
    variables = _variables(jmodel)
    j_eval = jax.jit(lambda v: jmodel.apply(v, BATCH, train=False)[
        "logits"])(variables)
    load_flax_variables(tmodel, variables)
    tb = batch_to_torch(BATCH, "cpu")
    tmodel.eval()
    with torch.no_grad():
        t_eval = tmodel(tb)["logits"].numpy()
    masks = []
    with pytest.MonkeyPatch.context() as mp:
        _recording_relu(mp, masks)
        tmodel.train()
        logits = tmodel(tb)["logits"]
    t_loss = masked_ce_torch(logits, labels, loss_valid)
    t_loss.backward()
    with pytest.MonkeyPatch.context() as mp:
        _imposed_relu(mp, masks)

        def loss(params):
            out, new = jmodel.apply(dict(variables, params=params), BATCH,
                                    train=True, mutable=["batch_stats"])
            return (masked_ce_jax(out["logits"], labels, loss_valid),
                    (out, new))

        (j_loss, (j_out, j_new)), j_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
    got = {"loss": float(t_loss.detach()), "logits": logits.detach().numpy(),
           "eval": t_eval, "grads": to_flax_tree(tmodel, "grads"),
           "stats": to_flax_tree(tmodel, "batch_stats"), "gates": len(masks)}
    want = {"loss": float(j_loss), "logits": np.asarray(j_out["logits"]),
            "eval": np.asarray(j_eval), "grads": jax.device_get(j_grads),
            "stats": jax.device_get(j_new["batch_stats"])}
    return got, want


def _assert_close(got, want, rows, zero_leaves=()):
    for key in ("logits", "eval"):
        assert rel_err(got[key][rows], want[key][rows]) <= MODEL_RTOL, key
    assert abs(got["loss"] - want["loss"]) <= MODEL_RTOL * abs(want["loss"])
    errs = leaf_errs(got["stats"], want["stats"])
    assert max(errs.values()) <= MODEL_RTOL, errs
    g, w = flat_leaves(got["grads"]), flat_leaves(want["grads"])
    top = max(float(np.abs(v).max()) for v in w.values())
    errs = {}
    for k in w:
        if k in zero_leaves:
            assert np.abs(g[k] - w[k]).max() <= ZERO_LEAF_ATOL * top, k
        else:
            errs[k] = rel_err(g[k], w[k])
    assert max(errs.values()) <= MODEL_RTOL, errs


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_tnet_matches_jax(train):
    x = np.concatenate([BATCH["pos"], BATCH["feats"]], 1).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=(SAMPLES, 3, 3)).astype(
        np.float32)
    got, want = layer_runs(jpt.TNet(3, SAMPLES),
                           tpt.TNet(7, 3, SAMPLES, device="cpu"),
                           (x, LEVEL["batch_idx"], VALID), cot, train=train)
    assert_layer_close(got, want, LAYER_RTOL)


def test_global_max_pools_are_bit_exact():
    """Every segment max of a PointNetSeg train forward, held bit for bit
    against the JAX package's ``segment_reduce`` on the same input, forward
    and gradient (the port's plain version on CPU tensors; its kernel on the
    card is held against that in ``chip_smoke.py``)."""
    calls = []
    inner = tseg.segment_reduce

    def record(x, ids, n, reduce, valid=None, ptr=None):
        calls.append((x.detach().clone(), ids, n, reduce, valid))
        return inner(x, ids, n, reduce, valid, ptr)

    model = tpt.PointNetSeg(CLASSES, 4, SAMPLES, device="cpu", seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpt.seg, "segment_reduce", record)
        model.train()(batch_to_torch(BATCH, "cpu"))
    assert [(c[0].shape[1], c[2], c[3]) for c in calls] == [
        (1024, SAMPLES + 1, "max")] * 3
    rng = np.random.default_rng(3)
    for x, ids, n, reduce, valid in calls:
        cot = rng.normal(size=(n, x.shape[1])).astype(np.float32)
        xn = x.numpy()
        want, vjp = jax.vjp(lambda a: jseg.segment_reduce(
            a, ids.numpy(), n, reduce, valid.numpy()), xn)
        (want_g,) = vjp(cot)
        tx = x.clone().requires_grad_()
        got = tseg.segment_reduce(tx, ids, n, reduce, valid)
        (got * torch.from_numpy(cot)).sum().backward()
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
        assert np.array_equal(tx.grad.numpy(), np.asarray(want_g))
        # the padding segment holds no valid row: 0
        assert (got[n - 1] == 0).all()


# --- models -----------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_runs():
    labels = np.clip(BATCH["labels"], 0, CLASSES - 1).astype(np.int32)
    return _runs(jpt.PointNetSeg(CLASSES, num_batches=SAMPLES),
                 tpt.PointNetSeg(CLASSES, 4, SAMPLES, device="cpu",
                                 seed=None), labels, VALID)


def test_pointnet_seg_matches_jax(seg_runs):
    got, want = seg_runs
    assert got["logits"].shape == want["logits"].shape == (1024, CLASSES)
    # the gates of stn3 (5), the local MLP (2), stnf (5), the global MLP (3)
    # and the head (3)
    assert got["gates"] == 5 + 2 + 5 + 3 + 3
    _assert_close(got, want, VALID,
                  zero_leaves=("encoder/MaskedBatchNorm_4/bias",))


def test_pointnet_cls_matches_jax():
    got, want = _runs(jpt.PointNetCls(7, num_batches=SAMPLES),
                      tpt.PointNetCls(7, 4, SAMPLES, device="cpu", seed=None),
                      np.array([3, 5], np.int32), np.ones(SAMPLES, bool))
    assert got["logits"].shape == (SAMPLES, 7)
    _assert_close(got, want, slice(None))


def test_pointnet_cls_dropout_follows_the_generator(monkeypatch):
    """In training mode the classifier's Dropout(0.3) draws from the
    generator it is given, and only then: the same mask imposed on the JAX
    module's ``nn.Dropout`` gives the same logits; no generator, no
    dropout (flax's ``has_rng("dropout")``); eval mode never draws."""
    jmodel = jpt.PointNetCls(CLASSES, num_batches=SAMPLES)
    variables = _variables(jmodel)
    tmodel = tpt.PointNetCls(CLASSES, 4, SAMPLES, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    tb = batch_to_torch(BATCH, "cpu")
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}

    def port(train, seed=None):
        tmodel.load_state_dict(state)
        tmodel.train(train)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tmodel(tb, generator=gen)["logits"].numpy()

    def jax_logits(keep=None):
        if keep is not None:
            proxy = types.SimpleNamespace(**{
                k: getattr(flax.linen, k) for k in dir(flax.linen)
                if not k.startswith("__")})
            proxy.Dropout = lambda rate, deterministic=None: (
                lambda h: jnp.where(keep, h / (1.0 - rate), 0.0))
            monkeypatch.setattr(jpt, "nn", proxy)
        out, _ = jmodel.apply(variables, BATCH, train=True,
                              mutable=["batch_stats"])
        monkeypatch.undo()
        return np.asarray(out["logits"])

    plain = port(True)
    assert rel_err(plain, jax_logits()) <= MODEL_RTOL
    dropped = port(True, 1)
    keep = (branch._uniform((SAMPLES, 256), torch.Generator().manual_seed(1),
                            "cpu") >= tpt.DROPOUT).numpy()
    assert 0 < keep.sum() < keep.size
    assert rel_err(dropped, jax_logits(keep)) <= MODEL_RTOL
    assert not np.array_equal(dropped, plain)
    assert np.array_equal(dropped, port(True, 1))
    assert not np.array_equal(dropped, port(True, 2))
    assert np.array_equal(port(False, 1), port(False))


@pytest.mark.parametrize("head", ["seg", "cls"])
def test_seeded_init_under_the_flax_names(head):
    if head == "seg":
        jmodel = jpt.PointNetSeg(CLASSES, num_batches=SAMPLES)
        make = lambda: tpt.PointNetSeg(CLASSES, 4, SAMPLES,  # noqa: E731
                                       device="cpu", seed=4)
    else:
        jmodel = jpt.PointNetCls(CLASSES, num_batches=SAMPLES)
        make = lambda: tpt.PointNetCls(CLASSES, 4, SAMPLES,  # noqa: E731
                                       device="cpu", seed=4)
    a, b = make(), make()
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert_same_tree(a, jmodel, BATCH, train=False)
    # the T-Nets start at the identity, as flax's zeros initializers put them
    for t in (a.encoder.stn3, a.encoder.stnf):
        assert not t.Dense_5.weight.any() and not t.Dense_5.bias.any()


# --- six Adam steps (ROADMAP C: PointNetCls's loss rises on the card) -------

STEPS, BLOCKS, BLOCK_POINTS, CLS_CLASSES = 6, 8, 128, 40
STEP_RTOL = 1e-4


def _blocks():
    """Eight blocks of 128 voxels of synthetic rooms at 5 cm, one class per
    block, collated by the JAX package: the shape of ``chip_smoke.py``'s
    phase 12 batch (8 blocks of 4096), cut in rows."""
    from deepviewagg_tpu.data.synthetic import make_scene

    rng = np.random.default_rng(0)
    samples = []
    for s in range(BLOCKS):
        scene = make_scene(seed=s, n_cameras=1, image_size=(32, 16))
        g = jvoxel.grid_sample(scene.pos, 0.05, feats=scene.rgb,
                               labels=scene.labels)
        take = np.sort(rng.choice(len(g["pos"]), BLOCK_POINTS, replace=False))
        samples.append(Sample(
            coords=g["coords"][take, 1:], labels=g["labels"][take],
            pos=g["pos"][take], feats=np.concatenate(
                [g["feats"][take], np.ones((BLOCK_POINTS, 1), np.float32)],
                1)))
    batch = device_view(collate(samples, Bucket(
        level_caps=[BLOCKS * BLOCK_POINTS] * 5, num_batches=BLOCKS),
        conv0_kernel=3))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    batch["cls_label"] = (np.arange(BLOCKS) % CLS_CLASSES).astype(np.int32)
    return batch


def _adam_state_to_port(tmodel, variables, adam):
    """optax's Adam moments (flax layout) as the port optimizer's state:
    each moment tree loaded into a copy of the model, read back in the
    model's parameter order."""
    import copy

    groups = {}
    for name in ("mu", "nu"):
        holder = copy.deepcopy(tmodel)
        load_flax_variables(holder, dict(variables, params=getattr(adam,
                                                                   name)))
        groups[name] = [p.detach().clone() for p in holder.parameters()]
    return {"count": int(adam.count), "mini_step": 0, "groups": [groups]}


def test_pointnet_cls_six_steps_match_jax():
    """Six Adam steps (LR 3e-3, clip 10, no weight decay, no dropout:
    ``chip_smoke.py::task_adam``) of the classifier: the JAX package's
    step runs free from the port's seeded start; before each of its steps
    the port is given JAX's state (parameters, running statistics, Adam
    moments and count) and takes the same step: loss and gradient norm
    within 1e-4 at every step.

    Free-running, the two trajectories part after the first update, and so
    does JAX from itself: Adam's first update is ``lr * sign(g)`` for every
    element, and a fifth of the gradient elements lie below 1e-6 of their
    leaf's largest, where the sign is rounding noise.  At phase 12's size
    (8 x 4096 rows) on the CPU, the port's losses 5.1348, 5.7186, 7.9774,
    11.8403, 10.6987, 11.1847 (the card's, to 1e-2), JAX's 5.1348, 5.7211,
    8.0739, 11.1429, 11.0772, 11.6184, and JAX from parameters moved by
    1e-7 relative 5.1348, 5.7187, 7.9779, 11.7641, 10.7713, 11.1083: the
    rise is the model's at these settings, not a fault of the port."""
    from deepviewagg_tpu.train import step as jstep
    from deepviewagg_tpu.train import task_steps as jts
    from deepviewagg_tpu.train.optimizers import make_optimizer as jopt
    from deepviewagg_tpu.train.optimizers import make_schedule as jsched
    from deepviewagg_tpu_torch.train import task_steps as tts
    from deepviewagg_tpu_torch.train.optimizers import (make_optimizer,
                                                        make_schedule)
    from deepviewagg_tpu_torch.train.step import TrainState

    batch = _blocks()
    labels = batch["cls_label"]
    jbatch = {k: v for k, v in batch.items() if k != "cls_label"}
    tmodel = tpt.PointNetCls(CLS_CLASSES, 4, BLOCKS, device="cpu", seed=0)
    copy_tree = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.array(a, copy=True), t)
    variables = {"params": copy_tree(to_flax_tree(tmodel, "params")),
                 "batch_stats": copy_tree(to_flax_tree(tmodel,
                                                       "batch_stats"))}
    jmodel = jpt.PointNetCls(CLS_CLASSES, num_batches=BLOCKS)
    jstate = jstep.TrainState.create(variables, jopt(
        jsched("constant", 3e-3), optimizer="adam", weight_decay=0.0,
        grad_clip=10.0))

    @jax.jit
    def jax_step(state):
        def loss_fn(params):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": state.batch_stats}, jbatch,
                train=True, mutable=["batch_stats"])
            ll = jnp.take_along_axis(jax.nn.log_softmax(out["logits"]),
                                     labels[:, None], axis=1)[:, 0]
            return -jnp.mean(ll), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return jts._update(state, grads, loss, {"batch_stats": stats})

    tstate = TrainState.create(tmodel, make_optimizer(
        make_schedule("constant", 3e-3), optimizer="adam", weight_decay=0.0,
        grad_clip=10.0))
    tstep = tts.make_classification_step(tmodel)
    tbatch = batch_to_torch(batch, "cpu")
    losses = []
    for i in range(STEPS):
        start = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        load_flax_variables(tmodel, start)
        adam = jstate.opt_state[1][0]
        assert int(adam.count) == i
        tstate.tx.load_state_dict(_adam_state_to_port(tmodel, start, adam))
        tstate, got = tstep(tstate, tbatch, None)
        jstate, want = jax_step(jstate)
        for key in ("loss", "grad_norm"):
            w = float(want[key])
            assert abs(float(got[key]) - w) <= STEP_RTOL * abs(w), (i, key)
        losses.append(float(want["loss"]))
    assert np.isfinite(losses).all()
