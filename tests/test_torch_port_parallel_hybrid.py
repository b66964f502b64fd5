"""View parallelism: the port's hybrid ``(data x model)`` step against the
JAX package's, and the view-sharded tower against the unsharded one.

Four spawned gloo ranks (``torch_port_parallel.Ranks``) form a 2 x 2 mesh.
(a) ``parallel.mesh.hybrid_parallel_step`` on two batches (one per data
index, each shared by a model group that splits its three images, so the
ceil-block zero padding runs) against JAX ``hybrid_parallel_step`` on a
2 x 2 mesh of virtual devices, from the same converted variables, two SGD +
momentum steps, float32 operands: held to the bounds of
``test_torch_port_parallel_dp.py`` for its group-norm case (the same
batches' arithmetic).  (b) Every rank on one batch with the towers sharded
over its model group: the gradients (mean over the group) against one
process's unsharded gradients per leaf within ``1e-6 + 1e-4 * |g|inf``
(``test_view_parallel.py``: a double-counted or dropped tower gradient errs
at 1e-1), under ``remat='convs'`` and ``remat=False`` alike; a frozen
tower's logits; and a shared ConvDown2D trunk's two taps, sharded against
unsharded within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.collate import collate
from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.data.toy import toy_batch
from deepviewagg_tpu.models.segmentation import MultimodalSeg as JaxSeg
from deepviewagg_tpu.modules import image_encoders as jax_towers
from deepviewagg_tpu.parallel import mesh as jmesh
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu_torch.cli import train as cli
from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.modules.image_encoders import f32_convs, run_tower
from deepviewagg_tpu_torch.utils.from_jax import to_flax_tree
from torch_port_parallel import (LR, OPT, TINY_SPEC, Ranks, loss_grads,
                                 port_model, trunk)
from torch_port_util import (_torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves,
                             jax_model_variables, rel_err,
                             write_resnet18_checkpoint)

KW = dict(n_samples=1, density=25.0, image_size=(64, 32), n_cameras=3)
NUM_CLASSES = jax_flagship_spec(**TINY_SPEC).num_classes


def _jax_spec():
    spec = jax_flagship_spec(**TINY_SPEC)
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, tower_bf16=False))
        for lvl, b in spec.branches))


def _batches():
    """The seed-0 scene with three cameras, and the same voxels and mapping
    with other labels, colours and images."""
    _, bucket, (s,) = toy_batch(**KW, headroom=1.3)
    lab = s.labels
    other = dataclasses.replace(
        s, labels=np.where(lab >= 0, (lab + 1) % NUM_CLASSES, lab),
        feats=np.concatenate([np.roll(s.feats[:, :3], 1, axis=1),
                              s.feats[:, 3:]], axis=1),
        images=np.roll(s.images, 1, axis=-1))
    return [{k: v for k, v in collate([x], bucket, branch_levels=(0,)).items()
             if k != "meta"} for x in (s, other)]


def _jax_hybrid(model, variables, batches, steps=2):
    tx = jopt.make_optimizer(jopt.make_schedule("constant", LR), **OPT)
    mesh = jmesh.make_hybrid_mesh(jax.devices()[:4], n_model=2)
    run = jmesh.hybrid_parallel_step(
        jstep.make_train_step(model, axis=("data", "model")), mesh,
        donate_state=False)
    state = jmesh.replicate(jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx), mesh)
    metrics, trees = [], []
    for _ in range(steps):
        state, m = run(state, batches, jax.random.PRNGKey(0))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        trees.append({"params": jax.device_get(state.params),
                      "batch_stats": jax.device_get(state.batch_stats)})
    return {"metrics": metrics, "steps": trees}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = JaxSeg(_jax_spec())
    variables = jax_model_variables(jm, seed=1)
    batches = _batches()
    images = np.random.default_rng(4).random((3, 32, 16, 3), np.float32)
    inputs = {"cases": [dict(name="hybrid", variables=variables,
                             batches=batches, steps=2, n_model=2)],
              "variables": variables, "batch": batches[0],
              "images": images}
    ranks = Ranks(4, ["steps", "shard"], tmp_path_factory.mktemp("hy"),
                  inputs)
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jax_towers.f32_convs():
            ref["hybrid"] = _jax_hybrid(jm, variables, batches)
        with f32_convs():
            ref["grads"] = to_flax_tree(
                loss_grads(port_model(variables), batches[0]), "grads")
            with torch.no_grad():
                ref["taps"] = [t.numpy() for t in run_tower(
                    trunk(), torch.tensor(images), False, bf16=False)]
            frozen = port_model(variables, frozen=True)
            frozen.train()
            ref["frozen_logits"] = frozen(batch_to_torch(
                batches[0], "cpu"))["logits"].detach().numpy()
    got = ranks.wait()
    return ref, got, variables


def _worst(got, ref):
    got, ref = flat_leaves(got), flat_leaves(ref)
    assert sorted(got) == sorted(ref)
    return max((rel_err(got[k], ref[k]), k) for k in ref)


def test_hybrid_step_matches_jax(runs):
    ref, got, _ = runs
    want = ref["hybrid"]
    for r in range(4):
        mine = got["steps"][r]["hybrid"]
        for g, j in zip(mine["metrics"], want["metrics"]):
            assert abs(float(g["loss"]) - float(j["loss"])) \
                <= 2e-5 * abs(float(j["loss"]))
        g, j = mine["metrics"][0], want["metrics"][0]
        assert abs(float(g["grad_norm"]) - float(j["grad_norm"])) \
            <= 1e-4 * float(j["grad_norm"])
    mine = got["steps"][0]["hybrid"]
    for i, p_bound, s_bound in ((0, 1e-4, 2e-5), (1, 1e-2, 1e-3)):
        err, leaf = _worst(mine["steps"][i]["params"],
                           want["steps"][i]["params"])
        assert err <= p_bound, (i, leaf, err)
        err, leaf = _worst(mine["steps"][i]["batch_stats"],
                           want["steps"][i]["batch_stats"])
        assert err <= s_bound, (i, leaf, err)


def test_hybrid_ranks_agree_and_model_groups_share_predictions(runs):
    _, got, _ = runs
    res = [got["steps"][r]["hybrid"] for r in range(4)]
    assert len({r["digest"] for r in res}) == 1
    p = [r["metrics"][0]["preds"] for r in res]
    # ranks 0, 1 hold data index 0, ranks 2, 3 data index 1
    assert np.array_equal(p[0], p[1]) and np.array_equal(p[2], p[3])
    assert not np.array_equal(p[0], p[2])


@pytest.mark.parametrize("remat", [False, "convs"])
def test_view_sharded_grads_match_unsharded(runs, remat):
    ref, got, _ = runs
    want = flat_leaves(ref["grads"])
    for r in range(4):
        assert got["shard"][r]["groups"] == ([0, 1] if r < 2 else [2, 3])
        mine = flat_leaves(got["shard"][r][f"grads_{remat}"])
        assert sorted(mine) == sorted(want)
        for k, g in want.items():
            tol = 1e-6 + 1e-4 * max(float(np.abs(g).max()), 1e-12)
            assert float(np.abs(mine[k] - g).max()) <= tol, k
    assert any("tower" in k and np.abs(g).max() > 0 for k, g in want.items())


def test_remat_convs_under_sharding_equals_no_remat(runs):
    _, got, _ = runs
    for r in range(4):
        a = flat_leaves(got["shard"][r]["grads_convs"])
        b = flat_leaves(got["shard"][r]["grads_False"])
        assert max(rel_err(a[k], b[k]) for k in b) <= 1e-6


def test_frozen_tower_and_shared_trunk_taps_shard_identically(runs):
    ref, got, _ = runs
    for r in range(4):
        res = got["shard"][r]
        assert len(res["taps"]) == len(ref["taps"]) == 2
        for g, w in zip(res["taps"], ref["taps"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["frozen_logits"], ref["frozen_logits"],
                                   rtol=1e-5, atol=1e-5)


def _cli_args(tmp_path, *extra):
    return ["--config", "conf/synthetic.yaml", "--device", "cpu",
            "training.epochs=1", "data.samples_per_epoch=4",
            f"data.root={tmp_path / 'data'}",
            f"training.run_dir={tmp_path / 'run'}",
            "training.tensorboard=false", "data.image_size=[64, 32]",
            "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}", *extra]


@pytest.mark.parametrize("bn_tower,match", [
    (True, "requires GroupNorm towers"),
    (False, "must divide the world size"),
])
def test_cli_refuses_what_cannot_shard(tmp_path, monkeypatch, bn_tower,
                                       match):
    """A BatchNorm tower (a pretrained checkpoint's) with
    ``view_parallel=2`` raises JAX's ValueError; a model axis that does not
    divide the world (here a world of one) raises too."""
    monkeypatch.chdir(cli.__file__.rsplit("/deepviewagg_tpu_torch/", 1)[0])
    extra = ["model.overrides={backbone: Res16UNetTest}",
             "training.data_parallel=true", "training.view_parallel=2"]
    if bn_tower:
        extra.append("model.tower_weights=" + write_resnet18_checkpoint(
            tmp_path / "r18.pth"))
    with pytest.raises(ValueError, match=match):
        cli.main(_cli_args(tmp_path, *extra))
    assert not torch.distributed.is_initialized()
