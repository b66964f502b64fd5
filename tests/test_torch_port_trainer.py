"""The experiment loop of the PyTorch port against the JAX package:
gradient accumulation against ``optax.MultiSteps``, the optimizer's
``state_dict``, the whole ``Trainer`` (two epochs with an eval each, on one
synthetic cache and one loader order, from one initial state) against the
JAX ``Trainer``, checkpoint and resume, the NaN guard, BN-momentum
milestones, profiling and the ``cli.train`` entry point.

Tolerances: accumulated SGD / AdamW updates within 1e-6 of optax; in the
loop, with float32 operands everywhere (``f32_sparse_convs``, the towers'
``f32_convs``), per-step losses within 1e-4 relative; final parameters and
running statistics within 1e-4 as a whole (the L2 norm of the difference
over that of the JAX state; measured 1.6e-5 and 1.8e-6) and every leaf
within 1e-3 of ``max(|leaf|, 1)`` (measured at most 5.4e-4, in the set
encoder: at this tiny size the masked batch norms' train-mode statistics
over a few voxels or views amplify float32 noise, and single gradient leaves
of one step already differ by up to 1e-3 relative); tracked metrics
(percent) within 1e-3 absolute.  Resume on the CPU is bit-equal to an
uninterrupted run.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train as jax_train_cli
from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.config.run import load_run_config as jax_load_run_config
from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import synthetic_ds as jsds
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import trainer as jtrainer
from deepviewagg_tpu_torch.cli import train as cli
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.config.run import load_run_config
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import synthetic_ds as tsds
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.nn.norm import MaskedBatchNorm
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import trainer as ttrainer
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (SCANNET_SCANS, _torch_threads,  # noqa: F401
                             f32_sparse_convs, fake_kitti360_layout,
                             fake_s3dis_layout, fake_scannet_layout,
                             flat_leaves, rel_err)

# the Quick start model's branch without ``-interpolate``: with bilinear
# taps, pixels clamped at an image edge give the atomic max EXACT ties, which
# the two frameworks' tap arithmetic need not reproduce alike, so the max's
# gradient goes to other pixels in one than in the other and tower leaves
# differ by 0.5% after one update; integer-pixel gathers copy features bit
# for bit, so ties are the same in both (the bilinear gather is held in
# ``test_torch_port_branch.py``)
MODEL = "Res16UNet14-L1-early-group2"
TINY = {"backbone": "Res16UNetTest", "tower_bf16": False}
DATA = dict(n_areas=1, radius=1.5, voxel_size=0.15, image_slots=2,
            samples_per_epoch=4, image_size=(64, 32), density=30.0,
            n_cameras=2)
LOOP = dict(epochs=2, eval_frequency=1, grad_accumulate=2, base_lr=0.05,
            lr_schedule="multi_step", lr_milestones=(1,), lr_gamma=0.5,
            track_every=1, tensorboard=False)


# --- gradient accumulation and optimizer state ------------------------------

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_grad_accumulation_matches_optax_multisteps(optimizer):
    """k = 2 over 4 mini-steps: two real updates.  The schedule's milestone
    at update 2 would bite on the second update if mini-steps were counted
    instead of updates."""
    kw = dict(optimizer=optimizer, momentum=0.9, weight_decay=1e-2,
              grad_clip=1.0)
    sched = dict(kind="multi_step", base_lr=0.1, milestones=(2,), gamma=0.5)
    params = _params(0)
    grads = [_params(10 + i) for i in range(4)]
    tx = optax.MultiSteps(jopt.make_optimizer(jopt.make_schedule(**sched),
                                              **kw), 2)
    ref = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(ref)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = topt.make_optimizer(topt.make_schedule(**sched), grad_accumulate=2,
                              **kw).init(tparams.items())
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, ref)
        ref = optax.apply_updates(ref, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        moved = opt.update()
        assert moved is (i % 2 == 1)
        for k, p in tparams.items():
            assert rel_err(p.detach().numpy(), np.asarray(ref[k])) <= 1e-6
        assert opt.mini_step == int(state.mini_step)
        assert opt.count == int(state.gradient_step) == (i + 1) // 2
        for _, count in optax.tree_utils.tree_get_all_with_path(
                state.inner_opt_state, "count"):
            assert int(count) == opt.count
        names = ("trace",) if optimizer == "sgd" else ("mu", "nu")
        (group,) = opt.groups
        for name in names:
            want = optax.tree_utils.tree_get(state.inner_opt_state, name)
            if name not in group.state:       # made at the first update
                assert opt.count == 0
                assert not any(np.asarray(w).any() for w in want.values())
                continue
            for k, t in zip(tparams, group.state[name]):
                assert rel_err(t.numpy(), np.asarray(want[k])) <= 1e-6
        for k, acc in zip(tparams, group.state["acc"]):
            assert rel_err(acc.numpy(), np.asarray(state.acc_grads[k])) <= 1e-6 \
                or not np.abs(np.asarray(state.acc_grads[k])).max()


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_optimizer_state_dict_round_trips(optimizer):
    def make(params):
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
        return tp, topt.make_optimizer(
            topt.make_schedule("constant", 0.1), optimizer=optimizer,
            grad_accumulate=3).init(tp.items())

    params = _params(1)
    pa, oa = make(params)
    for i in range(4):                          # one update + one mini-step
        for k, p in pa.items():
            p.grad = torch.from_numpy(_params(20 + i)[k])
        oa.update()
    saved = oa.state_dict()
    assert (saved["count"], saved["mini_step"]) == (1, 1)
    pb, ob = make({k: p.detach().numpy() for k, p in pa.items()})
    ob.load_state_dict(saved)
    for ga, gb in zip(oa.groups, ob.groups):
        assert sorted(ga.state) == sorted(gb.state)
        for key in ga.state:
            assert all(torch.equal(x, y)
                       for x, y in zip(ga.state[key], gb.state[key]))
    for i in range(2):
        for pp in (pa, pb):
            for k, p in pp.items():
                p.grad = torch.from_numpy(_params(30 + i)[k])
        oa.update(), ob.update()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    _, other = make(_params(2))
    bad = dict(saved, groups=[{"mu": [torch.zeros(2)] * 2}])
    with pytest.raises(ValueError):
        other.load_state_dict(bad)


# --- the whole loop against the JAX Trainer ---------------------------------

@pytest.fixture(scope="module")
def cache_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    jsds.build_synthetic_cache(root, n_areas=DATA["n_areas"],
                               density=DATA["density"],
                               n_cameras=DATA["n_cameras"],
                               image_size=DATA["image_size"])
    return root


def _jax_setup(root):
    cfg = jax_load_run_config(None, ["data.batch_size=2",
                                     "data.image_size=[64, 32]"])
    train_ds = jsds.make_synthetic_dataset(root, train=True, **DATA)
    val_ds = jsds.make_synthetic_dataset(root, train=False, **DATA)
    bucket = jax_train_cli.auto_bucket(cfg, train_ds, [0])
    return (jbase.BatchLoader(train_ds, bucket, 2, [0], shuffle=True, seed=0),
            jbase.BatchLoader(val_ds, bucket, 2, [0], shuffle=False), bucket)


def _torch_setup(root):
    cfg = load_run_config(None, ["data.batch_size=2",
                                 "data.image_size=[64, 32]"])
    train_ds = tsds.make_synthetic_dataset(root, train=True, device="cpu",
                                           **DATA)
    val_ds = tsds.make_synthetic_dataset(root, train=False, device="cpu",
                                         **DATA)
    bucket = cli.auto_bucket(cfg, train_ds, [0])
    return (tbase.BatchLoader(train_ds, bucket, 2, [0], shuffle=True, seed=0),
            tbase.BatchLoader(val_ds, bucket, 2, [0], shuffle=False), bucket)


def _recording(step, losses):
    def run(state, batch, rng):
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return run


@pytest.fixture(scope="module")
def loop_runs(cache_root):
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jt.f32_convs(), tt.f32_convs():
            return _run_loops(cache_root)


def _run_loops(root):
    log = []
    # --- the JAX package ----------------------------------------------
    jtrain, jval, jbucket = _jax_setup(root)
    jmodel = jseg.build_model(jzoo.get_model_spec(MODEL, 4, 4, TINY))
    example = next(iter(jbase.BatchLoader(  # a loader of its own: the
        jval.dataset, jbucket, 2, [0], shuffle=False)))  # others' rngs stay
    jtr = jtrainer.Trainer(jmodel, 4, jtrainer.TrainerConfig(
        log_fn=log.append, **LOOP), example_batch=example, seed=0)
    init = jax.device_get({"params": jtr.state.params,
                           "batch_stats": jtr.state.batch_stats})
    ref = {"losses": []}
    jtr._train_step = _recording(jtr._train_step, ref["losses"])
    ref["metrics"] = jtr.fit(lambda: iter(jtrain), lambda: iter(jval))
    ref["params"] = jax.device_get(jtr.state.params)
    ref["batch_stats"] = jax.device_get(jtr.state.batch_stats)
    ref["step"] = int(jtr.state.step)
    ref["updates"] = int(getattr(jtr.state.opt_state, "gradient_step", -1))

    # --- the port -------------------------------------------------------
    ttrain, tval, tbucket = _torch_setup(root)
    assert dataclasses.asdict(tbucket) == dataclasses.asdict(jbucket)
    tmodel = tseg.build_model(tzoo.get_model_spec(MODEL, 4, 4, TINY),
                              device="cpu", seed=None)
    ttr = ttrainer.Trainer(
        tmodel, 4, ttrainer.TrainerConfig(log_fn=log.append, **LOOP), seed=0,
        init_hook=lambda m: load_flax_variables(m, init))
    got = {"losses": []}
    ttr._train_step = _recording(ttr._train_step, got["losses"])
    got["metrics"] = ttr.fit(lambda: iter(ttrain), lambda: iter(tval))
    got["params"] = to_flax_tree(tmodel, "params")
    got["batch_stats"] = to_flax_tree(tmodel, "batch_stats")
    got["step"] = ttr.state.step
    got["updates"] = ttr.state.tx.count
    return ref, got, init, log


def test_loop_losses_match_jax(loop_runs):
    ref, got, _, _ = loop_runs
    assert len(got["losses"]) == len(ref["losses"]) == 4
    for g, r in zip(got["losses"], ref["losses"]):
        assert abs(g - r) <= 1e-4 * abs(r), (got["losses"], ref["losses"])
    assert got["step"] == ref["step"] == 4
    assert got["updates"] == ref["updates"] == 2


@pytest.mark.parametrize("what", ["params", "batch_stats"])
def test_loop_final_state_matches_jax(loop_runs, what):
    ref, got, init, _ = loop_runs
    g, r, i = (flat_leaves(t[what]) for t in (got, ref, init))
    assert sorted(g) == sorted(r)
    diff = np.sqrt(sum(((g[k].astype(np.float64) - r[k]) ** 2).sum()
                       for k in r))
    norm = np.sqrt(sum((r[k].astype(np.float64) ** 2).sum() for k in r))
    assert diff <= 1e-4 * norm
    errs = {k: float(np.abs(g[k] - r[k]).max() / max(np.abs(r[k]).max(), 1.0))
            for k in r}
    bad = {k: e for k, e in errs.items() if not e <= 1e-3}
    assert not bad, bad
    # the loop trained: every leaf moved from the shared initial state
    assert all(rel_err(g[k], i[k]) > 0 for k in r)


def test_loop_metrics_match_jax(loop_runs):
    ref, got, _, log = loop_runs
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for k, r in ref["metrics"].items():
        if k == "train_time_s":
            continue
        assert abs(got["metrics"][k] - r) <= 1e-3, (k, got["metrics"][k], r)
    assert {"val_miou", "train_miou", "train_loss"} <= set(got["metrics"])
    # both trainers wrote the same per-epoch lines, timings aside
    epochs = [line for line in log if line.startswith("epoch")]
    assert len(epochs) == 8


# --- checkpoints, resume, NaN guard ---------------------------------------

def _tiny_model(seed=0):
    return tseg.build_model(tzoo.get_model_spec(MODEL, 4, 4, TINY),
                            device="cpu", seed=seed)


@pytest.fixture(scope="module")
def epoch_batches(cache_root):
    train, val, _ = _torch_setup(cache_root)
    return [list(train), list(train)], list(val)


def _state_tensors(trainer):
    out = {f"model/{k}": v.clone()
           for k, v in trainer.model.state_dict().items()}
    for i, g in enumerate(trainer.state.tx.groups):
        for key, ts in g.state.items():
            out.update({f"opt/{i}/{key}/{j}": t.clone()
                        for j, t in enumerate(ts)})
    return out


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad[:5]


def test_resume_is_bit_equal_to_an_uninterrupted_run(epoch_batches,
                                                     tmp_path):
    """Two mini-steps per update over epochs of three and one batches, so
    the checkpoint falls in the middle of an accumulation."""
    train, val = epoch_batches
    batches = train[0] + train[1]
    epochs = [batches[:3], batches[3:]]

    def trainer(run_dir, n_epochs):
        return ttrainer.Trainer(_tiny_model(), 4, ttrainer.TrainerConfig(
            **dict(LOOP, epochs=n_epochs, run_dir=str(run_dir),
                   log_fn=lambda s: None)), seed=0,
            run_config={"model": {"overrides": {}}})

    whole = trainer(tmp_path / "whole", 2)
    order = iter(epochs)
    whole.fit(lambda: iter(next(order)), lambda: iter(val))

    first = trainer(tmp_path / "split", 1)
    first.fit(lambda: iter(epochs[0]), lambda: iter(val))
    saved = _state_tensors(first)
    assert (first.state.step, first.state.tx.count,
            first.state.tx.mini_step) == (3, 1, 1)
    second = trainer(tmp_path / "split", 1)
    assert not all(torch.equal(a, b) for a, b in zip(
        second.model.parameters(), first.model.parameters()))
    second.state = second.checkpoint.restore_state("latest", second.state)
    _assert_bit_equal(_state_tensors(second), saved)
    assert (second.state.step, second.state.tx.count,
            second.state.tx.mini_step) == (3, 1, 1)
    second.fit(lambda: iter(epochs[1]), lambda: iter(val))
    assert second.state.step == whole.state.step == 4
    _assert_bit_equal(_state_tensors(second), _state_tensors(whole))

    run_dir = tmp_path / "split"
    names = sorted(os.listdir(run_dir))
    assert {"run.json", "best.json", "metrics.jsonl", "latest.pt",
            "best_val_miou.pt", "best_train_loss.pt"} <= set(names)
    cfg_json = json.loads((run_dir / "run.json").read_text())
    assert cfg_json["model"]["overrides"]["stem_kernel"] == 3
    best = json.loads((run_dir / "best.json").read_text())
    assert set(best) >= {"val_miou", "train_loss"}
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 1]      # epochs restart at 1
    model = _tiny_model(seed=5)
    second.checkpoint.restore_variables("latest", model)
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), second.model.state_dict().values()))


def test_nan_guard_saves_crash_and_raises(epoch_batches, tmp_path):
    train, _ = epoch_batches
    tr = ttrainer.Trainer(_tiny_model(), 4, ttrainer.TrainerConfig(
        **dict(LOOP, run_dir=str(tmp_path), log_fn=lambda s: None)), seed=0)
    step = tr._train_step
    calls = []

    def poisoned(state, batch, gen):
        state, metrics = step(state, batch, gen)
        calls.append(1)
        if len(calls) == 2:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    tr._train_step = poisoned
    with pytest.raises(FloatingPointError, match="crash"):
        tr.fit(lambda: iter(train[0] + train[1]))
    # the previous step's loss is read after the next step: one poisoned
    # update lands before the abort
    assert len(calls) == 3
    assert tr.checkpoint.has("crash") and not tr.checkpoint.has("latest")
    saved = torch.load(tmp_path / "crash.pt", weights_only=True)
    assert saved["step"] == 3


def test_bn_momentum_milestones_reach_the_norms(epoch_batches):
    train, _ = epoch_batches

    def means(model):
        return [m.running_mean.clone() for m in model.modules()
                if isinstance(m, MaskedBatchNorm)]

    for milestones, moved in ((None, True), ({1: 1.0}, False)):
        model = _tiny_model()
        start = means(model)
        tr = ttrainer.Trainer(model, 4, ttrainer.TrainerConfig(
            **dict(LOOP, epochs=1, bn_momentum_milestones=milestones,
                   log_fn=lambda s: None)), seed=0)
        tr.fit(lambda: iter(train[0]))
        same = [torch.equal(a, b) for a, b in zip(start, means(model))]
        assert (not any(same)) if moved else all(same)


def test_profile_epoch_writes_a_trace(epoch_batches, tmp_path):
    train, _ = epoch_batches
    tr = ttrainer.Trainer(_tiny_model(), 4, ttrainer.TrainerConfig(
        **dict(LOOP, epochs=1, run_dir=str(tmp_path), profile_epochs=(1,),
               log_fn=lambda s: None)), seed=0)
    tr.fit(lambda: iter(train[0][:1]))
    assert (tmp_path / "profile_ep1.json").stat().st_size > 0


@pytest.mark.parametrize("every,epochs,dumped", [(1, 2, (1, 2)),
                                                  (2, 2, (2,)), (0, 1, ())])
def test_visualize_every_dumps_the_first_val_batch(epoch_batches, tmp_path,
                                                   every, epochs, dumped):
    """Every ``visualize_every``-th epoch's eval writes
    ``viz/epoch_<k>.ply``: the first val batch's valid points with their
    labels and the predictions of that eval, as ``save_ply_snapshot``
    writes them (the JAX trainer's ``_save_visuals``)."""
    from deepviewagg_tpu_torch.visualization import save_ply_snapshot

    train, val = epoch_batches
    preds = []
    tr = ttrainer.Trainer(_tiny_model(), 4, ttrainer.TrainerConfig(
        **dict(LOOP, epochs=epochs, run_dir=str(tmp_path / "run"),
               visualize_every=every, log_fn=lambda s: None)), seed=0)
    step = tr._eval_step

    def recording(state, batch):
        out = step(state, batch)
        preds.append(out["preds"].numpy())
        return out

    tr._eval_step = recording
    tr.fit(lambda: iter(train[0][:1]), lambda: iter(val))
    viz = tmp_path / "run" / "viz"
    names = sorted(os.listdir(viz)) if viz.exists() else []
    assert names == [f"epoch_{k}.ply" for k in dumped]
    b = val[0]
    n = b["meta"]["num_valid"]
    for k in dumped:
        want = tmp_path / f"want_{k}.ply"
        save_ply_snapshot(str(want), b["pos"][:n], labels=b["labels"][:n],
                          preds=preds[(k - 1) * len(val)][:n])
        assert (viz / f"epoch_{k}.ply").read_bytes() == want.read_bytes()


# --- the CLI -------------------------------------------------------------------

def _cli_args(tmp_path, *extra):
    return ["--config", "conf/synthetic.yaml", "--device", "cpu",
            "training.epochs=1", "data.samples_per_epoch=4",
            f"data.root={tmp_path / 'data'}",
            f"training.run_dir={tmp_path / 'run'}",
            "training.tensorboard=false", "data.image_size=[64, 32]",
            "model.overrides={backbone: Res16UNetTest}",
            "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}", *extra]


def test_cli_trains_one_epoch_and_resumes_on_the_cpu(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    metrics = cli.main(_cli_args(tmp_path))
    out = capsys.readouterr().out
    assert "bucket: levels=" in out and "epoch 1: train_acc=" in out
    assert "epoch 1 [val]: val_acc=" in out and "final:" in out
    run = tmp_path / "run"
    assert {"metrics.jsonl", "run.json", "best.json", "latest.pt",
            "best_val_miou.pt"} <= set(os.listdir(run))
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1 and "val_miou" in records[0]
    stored = json.loads((run / "run.json").read_text())
    assert stored["model"]["overrides"] == {"backbone": "Res16UNetTest",
                                            "stem_kernel": 3}
    steps = torch.load(run / "latest.pt", weights_only=True)["step"]
    assert steps == metrics["train_batches"] >= 1

    cli.main(_cli_args(tmp_path, "training.resume=true"))
    assert "resumed from latest checkpoint" in capsys.readouterr().out
    assert torch.load(run / "latest.pt", weights_only=True)["step"] == \
        steps + metrics["train_batches"]


def test_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _cli_args(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args)
    assert not (tmp_path / "data").exists()


@pytest.mark.parametrize("dataset", ["s3dis", "scannet", "kitti360"])
def test_cli_refuses_unported_datasets(tmp_path, dataset):
    """No dataset is refused any more: S3DIS, ScanNet and KITTI-360 each
    train one epoch with an eval on a miniature 2D-3D-S / ScanNet /
    KITTI-360 layout (KITTI-360's images in two camera-family buckets)."""
    if dataset == "scannet":
        root = fake_scannet_layout(str(tmp_path / "layout"))
        metrics = cli.main(_cli_args(
            tmp_path, "data.dataset=scannet", f"data.root={root}",
            "data.kwargs={radius: 1.5, samples_per_epoch: 4, frame_step: 2, "
            "image_size: [64, 32]}"))
        assert np.isfinite(metrics["val_miou"])
        assert sorted(f for f in os.listdir(
            os.path.join(root, "processed_dva")) if f.endswith(".npz")) == [
                f"{s}.npz" for s in SCANNET_SCANS]
        return
    if dataset == "s3dis":
        root = fake_s3dis_layout(str(tmp_path / "layout"))
        metrics = cli.main(_cli_args(
            tmp_path, "data.dataset=s3dis", f"data.root={root}",
            "data.kwargs={fold: 5, image_size: [64, 32]}"))
        assert np.isfinite(metrics["val_miou"])
        assert sorted(os.listdir(os.path.join(root, "processed_dva"))) == [
            "area_1.npz", "area_1_images.npy", "area_5.npz",
            "area_5_images.npy"]
        return
    root = fake_kitti360_layout(str(tmp_path / "layout"))
    metrics = cli.main(_cli_args(
        tmp_path, "data.dataset=kitti360", f"data.root={root}",
        "data.radius=4.0", "data.voxel_size=0.25",
        "data.kwargs={image_size: [64, 32], fisheye_size: [32, 32], "
        "max_images: 8}"))
    assert np.isfinite(metrics["val_miou"])
    assert len([f for f in os.listdir(os.path.join(root, "processed_dva"))
                if f.endswith(".npz")]) == 3
