"""The evaluation path of the PyTorch port against the JAX package:
``load_run_config(base=)``, ``VoteAccumulator`` (in RAM and spilled to
memmaps), its full-resolution 1-NN remap, and the whole ``cli.eval`` entry
point against the root ``eval.py`` on one synthetic cache with converted
parameters; the voting runs with and without MC dropout, the paths that
stay raising, and the TF32 pin of the entry points.

Tolerances: ``VoteAccumulator`` is host numpy copied from the JAX package,
so its arrays are byte-identical.  End to end the model is float32
throughout (``f32_sparse_convs``, the towers' ``f32_convs``, no
``-interpolate``: bilinear taps give the atomic max exact ties that the two
frameworks need not break alike), so logits agree to float32 noise: the
test asserts that no voxel's two largest logits lie within 1e-4 of each
other, and then the predictions are equal, the metrics agree within 1e-6
absolute and the vote arrays within 1e-5 relative.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import eval as jax_eval_cli
from deepviewagg_tpu.config.run import load_run_config as jax_load_run_config
from deepviewagg_tpu.config.zoo import resolve_spec_from_cfg as jax_resolve
from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu.data.datasets import synthetic_ds as jsds
from deepviewagg_tpu.metrics import tracker as jtracker
from deepviewagg_tpu.models.segmentation import build_model as jax_build_model
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.train import checkpoint as jckpt
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu.train import trainer as jtrainer
from deepviewagg_tpu_torch.cli import eval as cli
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.config.zoo import resolve_spec_from_cfg
from deepviewagg_tpu_torch.metrics import tracker as ttracker
from deepviewagg_tpu_torch.models.segmentation import build_model
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import checkpoint as tckpt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             jax_variables)

# the Quick start's branch without ``-interpolate`` on the test backbone,
# float32 towers
RUN = ["model.name=Res16UNet14-L1-early-group2",
       "model.overrides={backbone: Res16UNetTest, tower_bf16: false}",
       "data.dataset=synthetic", "data.voxel_size=0.15", "data.radius=1.5",
       "data.image_slots=2", "data.samples_per_epoch=4", "data.batch_size=2",
       "data.image_size=[64, 32]", "training.tensorboard=false"]
CACHE = dict(n_areas=1, density=30.0, n_cameras=2, image_size=(64, 32),
             keep_raw=True)
PARAM_SEED = 0


# --- load_run_config(base=) ------------------------------------------------

@pytest.mark.parametrize("overrides", [
    [], ["training.epochs=3", "data.kwargs={n_areas: 2}"],
    ["model.overrides.head_dropout=0.5", "data.voxel_size=0.02"]],
    ids=["none", "training_data", "into_stored_dict"])
def test_load_run_config_base_matches_jax(tmp_path, overrides):
    """A stored ``run.json`` (with the pinned stem kernel) refined by a
    YAML file and overrides.  A stored key that the schema lacks raises in
    the port (the JAX function skips it): the port reads only what it
    wrote."""
    stored = jax_load_run_config(None, RUN + [
        "data.kwargs={n_areas: 1, keep_raw: true}"]).to_dict()
    stored["model"]["overrides"]["stem_kernel"] = 3
    stored = json.loads(json.dumps(stored))
    yaml_path = tmp_path / "x.yaml"
    yaml_path.write_text("training:\n  base_lr: 0.02\ndata:\n  batch_size: 3\n")
    for path in (None, str(yaml_path)):
        got = trun.load_run_config(path, list(overrides),
                                   base=json.loads(json.dumps(stored)))
        want = jax_load_run_config(path, list(overrides),
                                   base=json.loads(json.dumps(stored)))
        assert got.to_dict() == want.to_dict()
    assert got.model.overrides["stem_kernel"] == 3
    assert got.training.base_lr == 0.02 and got.data.batch_size == 3
    retired = json.loads(json.dumps(stored))
    retired["training"]["retired_option"] = 1
    with pytest.raises(KeyError, match="TrainingCfg.retired_option"):
        trun.load_run_config(None, list(overrides), base=retired)


# --- VoteAccumulator ---------------------------------------------------------

def _vote_inputs(seed=0, num_classes=5):
    """Three clouds, adds with repeated ids (within a call and across)."""
    rng = np.random.default_rng(seed)
    sizes = {"a.npz": 300, "b.npz": 500, "c.npz": 120}
    adds = []
    for i in range(9):
        cloud = list(sizes)[i % 3]
        ids = rng.integers(0, sizes[cloud] - 40, 150)
        adds.append((cloud, sizes[cloud], ids,
                     rng.normal(size=(150, num_classes)).astype(np.float32)))
    return adds, num_classes


def _accumulate(cls, budget, adds, num_classes):
    acc = cls(num_classes, ram_budget_bytes=budget)
    for cloud, size, ids, logits in adds:
        acc.add(cloud, size, ids, logits)
    return acc


@pytest.mark.parametrize("budget", [None, 300 * (4 * 5 + 4)],
                         ids=["ram", "spilled"])
def test_vote_accumulator_byte_identical(budget):
    adds, k = _vote_inputs()
    ref = _accumulate(jtracker.VoteAccumulator, budget, adds, k)
    got = _accumulate(ttracker.VoteAccumulator, budget, adds, k)
    assert got.clouds() == ref.clouds() == ["a.npz", "b.npz", "c.npz"]
    assert got.spilled == ref.spilled == (0 if budget is None else 2)
    for cloud in ref.clouds():
        votes, counts = got.votes(cloud)
        for a, b in ((votes, ref._votes[cloud]), (counts, ref._counts[cloud])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert isinstance(votes, np.memmap) == (budget is not None
                                                and cloud != "a.npz")
        for a, b in zip(got.preds(cloud), ref.preds(cloud)):
            assert np.array_equal(a, b)
        # ids never drawn keep no vote
        assert not counts[-40:].any()
    spill = got._tempdir.name if budget is not None else None
    del got
    assert spill is None or not os.path.exists(spill)


def test_full_res_preds_match_jax():
    """Float positions in general position (no two candidates at the same
    distance from a raw point), a cloud with unvoted points."""
    adds, k = _vote_inputs(seed=1)
    ref = _accumulate(jtracker.VoteAccumulator, None, adds, k)
    got = _accumulate(ttracker.VoteAccumulator, None, adds, k)
    rng = np.random.default_rng(2)
    for cloud in ref.clouds():
        size = len(ref._counts[cloud])
        vote_pos = rng.random((size, 3)).astype(np.float32) * 4
        raw_pos = rng.random((3 * size + 17, 3)).astype(np.float32) * 4
        want = ref.full_res_preds(cloud, vote_pos, raw_pos)
        out = got.full_res_preds(cloud, vote_pos, raw_pos, device="cpu")
        assert out.dtype == want.dtype and out.shape == (len(raw_pos),)
        assert np.array_equal(out, want)
    empty = ttracker.VoteAccumulator(k)
    empty._alloc("e.npz", 4)
    assert np.array_equal(empty.full_res_preds(
        "e.npz", np.zeros((4, 3)), np.zeros((6, 3)), device="cpu"),
        np.zeros(6, np.int64))


# --- the whole entry point against eval.py -----------------------------------

class _Recorder:
    """Patches a package's ``VoteAccumulator`` so that every instance and
    every ``add``'s logits are kept."""

    def __init__(self, mp, owner):
        self.instances, self.logits = [], []
        base = owner.VoteAccumulator
        rec = self

        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.instances.append(self)

            def add(self, cloud, size, ids, logits):
                rec.logits.append(np.array(logits, np.float32))
                super().add(cloud, size, ids, logits)

        mp.setattr(owner, "VoteAccumulator", Recording)


def _run_config(root):
    cfg = jax_load_run_config(None, RUN + [
        f"data.root={root}",
        "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2, "
        "keep_raw: true}"])
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One synthetic cache (raw clouds kept), one set of flax variables,
    a JAX and a port run dir holding them; JAX ``eval.main`` run once
    (``--voting_runs 1 --full_res``) with its votes and logits recorded."""
    root = tmp_path_factory.mktemp("eval")
    data = str(root / "data")
    jsds.build_synthetic_cache(data, **CACHE)
    cfg = _run_config(data)
    run_config = json.loads(json.dumps(cfg.to_dict()))
    jspec = jax_resolve(cfg.model, 4)
    ds = jsds.make_synthetic_dataset(
        data, train=False, radius=cfg.data.radius,
        voxel_size=cfg.data.voxel_size, image_slots=cfg.data.image_slots,
        samples_per_epoch=4, **{k: v for k, v in CACHE.items()
                                if k != "keep_raw"})
    import train as jax_train_cli

    bucket = jax_train_cli.auto_bucket(cfg, ds, [0])
    example = next(iter(jbase.BatchLoader(ds, bucket, 2, [0], shuffle=False)))
    variables = jax_variables(jax_build_model(jspec),
                              {k: v for k, v in example.items()
                               if k != "meta"}, seed=PARAM_SEED, train=False)
    jdir, tdir = str(root / "jax_run"), str(root / "port_run")
    tcfg = jtrainer.TrainerConfig()
    jckpt.CheckpointManager(jdir, dict(run_config)).save_state(
        "latest", jstep.TrainState.create(variables, jopt.make_optimizer(
            jopt.make_schedule(tcfg.lr_schedule, tcfg.base_lr,
                               tcfg.total_steps, tcfg.lr_milestones,
                               tcfg.lr_gamma),
            tcfg.optimizer, tcfg.momentum, tcfg.weight_decay,
            tcfg.grad_clip)))
    model = build_model(resolve_spec_from_cfg(trun.load_run_config(
        None, [], base=run_config).model, 4), device="cpu", seed=None)
    load_flax_variables(model, variables)
    tckpt.CheckpointManager(tdir, dict(run_config)).save_state(
        "latest", tstep.TrainState.create(model, topt.make_optimizer(
            topt.make_schedule("constant", 0.1))))
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        rec = _Recorder(mp, jtracker)
        with jt.f32_convs():
            metrics = jax_eval_cli.main(["--run_dir", jdir, "--voting_runs",
                                         "1", "--full_res"])
    return {"root": root, "jax": jdir, "port": tdir, "metrics": metrics,
            "votes": rec.instances[0], "logits": rec.logits}


def _port_eval(runs, *args):
    """The port's ``cli.eval.main`` on the CPU in float32: (metrics, the
    vote accumulator, the logits of every ``add`` in order).  Two torch
    threads in every call, module fixtures included, so that the CPU GEMMs
    sum in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            f32_sparse_convs(mp)
            rec = _Recorder(mp, cli)
            with tt.f32_convs():
                metrics = cli.main(["--run_dir", runs["port"], "--device",
                                    "cpu", *args])
    finally:
        torch.set_num_threads(threads)
    return metrics, (rec.instances or [None])[0], rec.logits


@pytest.fixture(scope="module")
def port_run(runs):
    return _port_eval(runs, "--voting_runs", "1", "--full_res")


def test_eval_logits_have_no_near_ties(runs):
    logits = np.concatenate(runs["logits"])
    assert len(logits) > 500
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4


def test_eval_metrics_match_jax(runs, port_run):
    want, (got, _, _) = runs["metrics"], port_run
    assert sorted(got) == sorted(want)
    for stage in ("test", "vote", "full_res"):
        assert {f"{stage}_{m}" for m in ("acc", "macc", "miou")} <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)


def test_eval_votes_match_jax(runs, port_run):
    ref, (_, got, logits) = runs["votes"], port_run
    assert got.clouds() == ref.clouds() and len(got.clouds()) == 1
    assert len(logits) == len(runs["logits"])
    for a, b in zip(logits, runs["logits"]):
        assert np.array_equal(a.argmax(1), b.argmax(1))
    for cloud in ref.clouds():
        votes, counts = got.votes(cloud)
        assert np.array_equal(counts, ref._counts[cloud])
        assert counts.max() > 1            # overlapping eval spheres
        assert np.abs(votes - ref._votes[cloud]).max() <= \
            1e-5 * np.abs(ref._votes[cloud]).max()
        for a, b in zip(got.preds(cloud), ref.preds(cloud)):
            assert np.array_equal(a, b)


def test_eval_full_res_covers_the_raw_cloud(port_run):
    """One full-resolution prediction per ``raw_pos`` row."""
    _, votes, _ = port_run
    (cloud,) = votes.clouds()
    area = jbase.load_area(cloud)
    full = votes.full_res_preds(cloud, area["pos"], area["raw_pos"],
                                device="cpu")
    assert full.shape == (len(area["raw_pos"]),) == area["raw_labels"].shape
    assert len(area["raw_pos"]) > len(area["pos"])


def test_two_voting_runs_without_dropout_double_the_votes(runs, port_run):
    """Without dropout the second run's logits are the first's bit for bit,
    so each point's count doubles and its votes double: exactly where one
    sphere holds the point, to float32 rounding of the sums' order where
    several do."""
    _, one, one_logits = port_run
    metrics, two, two_logits = _port_eval(runs, "--voting_runs", "2")
    assert len(two_logits) == 2 * len(one_logits)
    half = len(one_logits)
    for a, b, c in zip(one_logits, two_logits[:half], two_logits[half:]):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    (cloud,) = one.clouds()
    v1, n1 = one.votes(cloud)
    v2, n2 = two.votes(cloud)
    assert np.array_equal(n2, 2 * n1)
    single = n1 == 1
    assert single.any()
    assert np.array_equal(v2[single], 2 * v1[single])
    assert np.abs(v2 - 2 * v1).max() <= 1e-6 * np.abs(v1).max()
    assert metrics["test_miou"] == port_run[0]["test_miou"]
    assert "full_res_miou" not in metrics


def _dropout_logits(runs, generator_seed):
    """Three voting runs of ``cli.eval`` on a model built from the run's
    spec with ``head_dropout = 0.5`` (``dataclasses.replace``: like the JAX
    zoo, the port's drops a ``head_dropout`` override), the MC-dropout
    generator seeded from ``generator_seed`` (the CLI seeds it from 0) by
    wrapping ``make_eval_step``'s MC step."""
    def make_eval_step(model, mc_dropout=False):
        step = tstep.make_eval_step(model, mc_dropout)
        if not mc_dropout:
            return step
        own = torch.Generator().manual_seed(generator_seed)
        return lambda state, batch, generator: step(state, batch, own)

    def with_dropout(spec, **kwargs):
        return build_model(dataclasses.replace(spec, head_dropout=0.5),
                           **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "make_eval_step", make_eval_step)
        mp.setattr(cli, "build_model", with_dropout)
        _, _, logits = _port_eval(runs, "--voting_runs", "3")
    n = len(logits) // 3
    return [np.concatenate(logits[i * n:(i + 1) * n]) for i in range(3)]


def test_mc_dropout_runs_repeat_per_seed(runs):
    """``head_dropout > 0``: the first run has no dropout, the others draw
    from the generator; one seed repeats bit for bit, another differs."""
    a = _dropout_logits(runs, 0)
    b = _dropout_logits(runs, 0)
    c = _dropout_logits(runs, 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(a[0], c[0])
    assert not np.array_equal(a[1], a[2])
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[1], c[1]) and not np.array_equal(a[2], c[2])
    assert all(np.isfinite(x).all() for x in a)


# --- what stays raising, and the entry points' TF32 pin ----------------------

def test_submission_and_no3d_raise(runs, tmp_path):
    """``--submission`` with ``data.dataset=kitti360`` is no longer refused:
    it reaches the KITTI-360 loader, which finds no window under this run's
    synthetic root (the KITTI-360 and ScanNet submissions are held in
    ``test_torch_port_kitti360.py`` and ``test_torch_port_scannet.py``); the
    ``no3d`` family still raises."""
    with pytest.raises(FileNotFoundError, match="no KITTI-360 windows"):
        cli.main(["--run_dir", runs["port"], "--device", "cpu",
                  "--submission", str(tmp_path), "data.dataset=kitti360"])
    with pytest.raises(NotImplementedError, match="propagate_unseen.*A.6"):
        cli.main(["--run_dir", runs["port"], "--device", "cpu",
                  "model.name=No3D-ADE20K-group8"])


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_entry_points_pin_tf32(runs, tmp_path, monkeypatch, entry):
    """Both TF32 flags read False after ``main --device cpu`` from a start
    where they were True; without ``--device`` the entry point raises where
    CUDA is absent."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if entry == "train":
        main = cli_train.main
        args = [*RUN, f"data.root={runs['root'] / 'data'}",
                "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}",
                "training.epochs=1", "data.samples_per_epoch=2",
                f"training.run_dir={tmp_path / 'run'}"]
    else:
        main = cli.main
        args = ["--run_dir", runs["port"]]
    main([*args, "--device", "cpu"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
