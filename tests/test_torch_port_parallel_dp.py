"""The port's data-parallel step against the JAX package's, and against
its own one-process step on the union batch.

Four spawned gloo ranks (``torch_port_parallel.Ranks``) run
``parallel.mesh.data_parallel_step`` on four tiny multimodal batches from
converted variables, two SGD + momentum steps, while the test process runs
JAX ``data_parallel_step`` on four virtual devices with the same variables
and batches (float32 operands everywhere: the two differ in summation order
only).  Once with a group-norm tower and the masked sync batch norms, once
with a ``tower_norm='batch'`` tower, whose BatchNorms normalize with each
rank's own images while their running statistics are averaged.

The four batches hold the voxels and mapping of the tiny batch every port
parity test uses (``TINY_BATCH``, seed 0) with other labels, colours and
images each.  The tiny model's gradient is discontinuous at float32
rounding (a ReLU or max flips): noise of 1e-6 relative on the input
features moves single gradient leaves of the port's own step by 2% on that
scene and by 6.4% on the scene of seed 10, where the port and the JAX
package differ by the same 6.4%.  And the second step amplifies the first
update's rounding: the port's own four ranks and its one process on the
union batch (the same arithmetic in another summation order) agree to
3.5e-6 after one step and differ by 4.5e-4 after two.  So the losses of
both steps are held to 2e-5; after the first step every parameter leaf to
1e-4 of its largest magnitude (1e-3 with the BatchNorm tower, whose
training-mode outputs already differ from flax's by up to 1e-4,
``test_torch_port_bn_towers.py``) and every running statistic to 2e-5;
after the second step parameters to 1e-2 and statistics to 1e-3 (measured:
3.1e-4 and 1.9e-6 with the group-norm tower, 4.3e-3 and 3.1e-4 with the
BatchNorm one), where a broken collective errs at 1e-1.

Union equivalence (``test_dp_equivalence.py``): with equal valid level-0
counts on every rank (the same voxels), the mean of the ranks' mean losses
is the union batch's mean loss and the mean gradient is the union gradient,
so four ranks equal one process on the union batch to float32 reduction
tolerance (2e-5).  A broken collective is order-sensitive or off by a
factor: the loss must not move when the ranks' batches are permuted, and
must move when every rank gets the same batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.collate import Bucket, collate
from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.data.toy import toy_batch
from deepviewagg_tpu.models.segmentation import MultimodalSeg as JaxSeg
from deepviewagg_tpu.modules import image_encoders as jax_towers
from deepviewagg_tpu.parallel import mesh as jmesh
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from torch_port_parallel import LR, OPT, TINY_SPEC, Ranks, port_model, \
    run_steps
from torch_port_util import (_torch_threads,  # noqa: F401
                             f32_sparse_convs, flat_leaves,
                             jax_model_variables, rel_err)

N = 4
KW = dict(n_samples=1, density=25.0, image_size=(64, 32), n_cameras=1)
NUM_CLASSES = jax_flagship_spec(**TINY_SPEC).num_classes


def _jax_spec(**branch):
    spec = jax_flagship_spec(**TINY_SPEC)
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, tower_bf16=False, **branch))
        for lvl, b in spec.branches))


def _strip(batch):
    return {k: v for k, v in batch.items() if k != "meta"}


def _variant(sample, k):
    """The same voxels and mapping (so the same valid counts) with other
    labels, colours and images."""
    lab = sample.labels
    return dataclasses.replace(
        sample, labels=np.where(lab >= 0, (lab + k) % NUM_CLASSES, lab),
        feats=np.concatenate([np.roll(sample.feats[:, :3], k, axis=1),
                              sample.feats[:, 3:]], axis=1),
        images=np.roll(sample.images, k, axis=-1))


def _union_batches():
    """Four same-count batches and their union, collated by the JAX
    package's pipeline."""
    _, bucket, samples = toy_batch(**KW, headroom=1.3)
    variants = [_variant(samples[0], k) for k in range(N)]
    per_rank = [_strip(collate([v], bucket, branch_levels=(0,)))
                for v in variants]
    union_bucket = Bucket(
        level_caps=[c * N for c in bucket.level_caps], num_batches=N,
        view_cap=bucket.view_cap * N, pix_cap=bucket.pix_cap * N,
        image_cap=bucket.image_cap * N, image_size=bucket.image_size)
    union = _strip(collate(variants, union_bucket, branch_levels=(0,)))
    return per_rank, union


def _jax_dp(model, variables, batches, steps=2):
    tx = jopt.make_optimizer(jopt.make_schedule("constant", LR), **OPT)
    mesh = jmesh.make_mesh(jax.devices()[:N])
    run = jmesh.data_parallel_step(jstep.make_train_step(model, axis="data"),
                                   mesh, donate_state=False)
    state = jmesh.replicate(jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx), mesh)
    metrics, trees = [], []
    for _ in range(steps):
        state, m = run(state, batches, jax.random.PRNGKey(0))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        trees.append({"params": jax.device_get(state.params),
                      "batch_stats": jax.device_get(state.batch_stats)})
    return {"metrics": metrics, "steps": trees, **trees[-1]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jg, jb = JaxSeg(_jax_spec()), JaxSeg(_jax_spec(tower_norm="batch"))
    vg = jax_model_variables(jg, seed=1)
    vb = jax_model_variables(jb, seed=2)
    per_rank, union = _union_batches()
    rotated = per_rank[1:] + per_rank[:1]
    cases = [
        dict(name="group", variables=vg, batches=per_rank, steps=2),
        dict(name="batch", variables=vb, batches=per_rank, steps=2,
             branch=dict(tower_norm="batch")),
        dict(name="permuted", variables=vg, batches=rotated, steps=1),
        dict(name="replicated", variables=vg, batches=[per_rank[0]] * N,
             steps=1),
    ]
    ranks = Ranks(N, ["steps"], tmp_path_factory.mktemp("dp"),
                  {"cases": cases})
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        with jax_towers.f32_convs():
            ref = {"group": _jax_dp(jg, vg, per_rank),
                   "batch": _jax_dp(jb, vb, per_rank)}
        from deepviewagg_tpu_torch.modules.image_encoders import f32_convs
        with f32_convs():
            ref["union"] = run_steps(port_model(vg), union, 2)
    got = ranks.wait()["steps"]
    return ref, got, {"group": vg, "batch": vb}


def _worst(got, ref):
    got, ref = flat_leaves(got), flat_leaves(ref)
    assert sorted(got) == sorted(ref)
    return max((rel_err(got[k], ref[k]), k) for k in ref)


# (first-step gradient norm and parameters, second-step parameters and
# running statistics), see the module docstring
BOUNDS = {"group": (1e-4, 1e-4, 1e-2, 1e-3), "batch": (1e-3, 1e-3, 1e-2, 1e-3)}


@pytest.mark.parametrize("case", ["group", "batch"])
def test_loss_matches_jax(runs, case):
    ref, got, _ = runs
    for r in range(N):
        for g, j in zip(got[r][case]["metrics"], ref[case]["metrics"]):
            assert abs(float(g["loss"]) - float(j["loss"])) \
                <= 2e-5 * abs(float(j["loss"]))
        g, j = got[r][case]["metrics"][0], ref[case]["metrics"][0]
        assert abs(float(g["grad_norm"]) - float(j["grad_norm"])) \
            <= BOUNDS[case][0] * float(j["grad_norm"])
    # the loss fell on the repeated batches
    losses = [float(m["loss"]) for m in got[0][case]["metrics"]]
    assert losses[1] < losses[0]


@pytest.mark.parametrize("case", ["group", "batch"])
def test_parameters_match_jax(runs, case):
    ref, got, variables = runs
    for i, bound in ((0, BOUNDS[case][1]), (1, BOUNDS[case][2])):
        err, leaf = _worst(got[0][case]["steps"][i]["params"],
                           ref[case]["steps"][i]["params"])
        assert err <= bound, (i, leaf, err)
    moved = flat_leaves(got[0][case]["params"])
    start = flat_leaves(variables[case]["params"])
    assert all(rel_err(moved[k], start[k]) > 0 for k in start)


@pytest.mark.parametrize("case", ["group", "batch"])
def test_running_statistics_match_jax(runs, case):
    ref, got, _ = runs
    for i, bound in ((0, 2e-5), (1, BOUNDS[case][3])):
        err, leaf = _worst(got[0][case]["steps"][i]["batch_stats"],
                           ref[case]["steps"][i]["batch_stats"])
        assert err <= bound, (i, leaf, err)
    if case == "batch":
        # the towers' BatchNorms are among the leaves, averaged over ranks
        assert any("tower" in k and k.endswith("mean")
                   for k in flat_leaves(got[0][case]["batch_stats"]))


@pytest.mark.parametrize("case", ["group", "batch", "permuted"])
def test_ranks_end_bit_equal_and_keep_their_predictions(runs, case):
    _, got, _ = runs
    assert len({got[r][case]["digest"] for r in range(N)}) == 1
    preds = [got[r][case]["metrics"][0]["preds"] for r in range(N)]
    assert not all(np.array_equal(preds[0], p) for p in preds[1:])


def test_union_batch_equivalence(runs):
    """After one step, as ``test_dp_equivalence.py`` checks; the second
    step's loss too."""
    ref, got, _ = runs
    one, dp = ref["union"], got[0]["group"]
    for a, b in zip(dp["metrics"], one["metrics"]):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   rtol=2e-5, atol=2e-5)
    for what in ("params", "batch_stats"):
        a = flat_leaves(dp["steps"][0][what])
        b = flat_leaves(one["steps"][0][what])
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-5,
                                       err_msg=f"{what}/{k}")


def test_rank_permutation_invariant_and_data_matters(runs):
    _, got, _ = runs
    loss = float(got[0]["group"]["metrics"][0]["loss"])
    permuted = float(got[0]["permuted"]["metrics"][0]["loss"])
    replicated = float(got[0]["replicated"]["metrics"][0]["loss"])
    assert abs(permuted - loss) <= 1e-6 * abs(loss)
    assert abs(replicated - loss) > 1e-6
    # and every rank holds the replicated mean
    assert {float(got[r]["replicated"]["metrics"][0]["loss"])
            for r in range(N)} == {replicated}


def test_the_port_ranks_did_not_import_jax():
    """The spawned ranks run the port alone (torch_port_parallel imports
    torch and the port only)."""
    import ast
    from pathlib import Path

    import torch_port_parallel

    tree = ast.parse(Path(torch_port_parallel.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & {"jax", "flax", "optax", "deepviewagg_tpu"}
    assert torch.distributed.is_available()
