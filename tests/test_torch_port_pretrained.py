"""Pretrained 2D towers in the PyTorch port against the JAX package:
``utils/torch_convert.py`` and ``utils/pretrained.py`` (``model.tower_weights``).

Random-weight ResNet-18 checkpoints with non-trivial BatchNorm statistics
are written in the published key layouts
(``torch_port_util.resnet18_state_dict``): torchvision's, and the
MIT-semseg deep-stem encoder with its PPM decoder under ``encoder.`` /
``decoder.``.  Each package's ``apply_tower_weights`` overlays the same
checkpoint on a model that starts from the same random variables; the
whole variable trees afterwards are equal exactly (the converters only
transpose), the towers' eval-mode outputs within 1e-5 (float32 operands),
and both refuse the same checkpoints.  ``resolve_spec_from_cfg`` gives the
same spec (the deep-stem sniff, the pin, the BatchNorm switch).  Then
``cli.train --device cpu`` with ``model.tower_weights`` pins the stem into
``run.json`` and ``cli.eval`` rebuilds the model after the checkpoint file
is gone.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from deepviewagg_tpu.config import run as jrun
from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu.models import segmentation as jseg
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.utils import pretrained as jpre
from deepviewagg_tpu_torch.cli import eval as cli_eval
from deepviewagg_tpu_torch.cli import train as cli_train
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.models import segmentation as tseg
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.utils import pretrained as tpre
from deepviewagg_tpu_torch.utils import torch_convert as tconv
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             flat_leaves, jax_tiny_batch, jax_variables,
                             rel_err, resnet18_state_dict,
                             write_resnet18_checkpoint)

PYRAMID = "Res16UNet34-PointPyramid-early-cityscapes-interpolate"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("pth")
    return {
        "torchvision": write_resnet18_checkpoint(root / "imagenet.pth"),
        "torchvision_wrapped": write_resnet18_checkpoint(
            root / "dp.pth", seed=1, wrap=True),
        "deep_ppm": write_resnet18_checkpoint(
            root / "ade20k.pth", deep_stem=True, ppm_channels=128, seed=2),
        "deep_ppm512": write_resnet18_checkpoint(
            root / "ade20k512.pth", deep_stem=True, ppm_channels=512, seed=3),
    }


def _specs(name, tower_weights, **overrides):
    """The two packages' specs of a zoo name on the test backbone, resolved
    with ``tower_weights``."""
    ov = dict(backbone="Res16UNetTest", tower_bf16=False, **overrides)
    return (jzoo.resolve_spec_from_cfg(jrun.ModelCfg(
                name=name, tower_weights=tower_weights, overrides=ov), 4),
            tzoo.resolve_spec_from_cfg(trun.ModelCfg(
                name=name, tower_weights=tower_weights, overrides=ov), 4))


def _loaded(jspec, tspec, path, seed=0):
    """Both models from the same random variables, each overlaid with the
    checkpoint at ``path`` by its own package."""
    batch, _ = jax_tiny_batch()
    jmodel = jseg.build_model(jspec)
    variables = jax_variables(jmodel, batch, seed=seed, train=False)
    tmodel = tseg.build_model(tspec, device="cpu", seed=None)
    load_flax_variables(tmodel, variables)
    jvars = jax.device_get(jpre.apply_tower_weights(variables, jspec, path))
    loaded = tpre.apply_tower_weights(tmodel, tspec, path)
    return jmodel, variables, jvars, tmodel, loaded


_CASES = {
    # (zoo name, checkpoint, overrides)
    "l1-torchvision": ("Res16UNet14-L1-early-group2", "torchvision", {}),
    "l2-wrapped": ("Res16UNet14-L2-early-group2", "torchvision_wrapped", {}),
    "ppm-deep-decoder": ("Res16UNet14-early-group2-ppm", "deep_ppm", {}),
    "l4-ade20k-deep": ("Res16UNet34-L4-early-ade20k-interpolate", "deep_ppm",
                       {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_loaded_trees_are_equal_to_jax(checkpoints, case):
    """After each package's ``apply_tower_weights``, the port's whole
    parameter and running-statistics trees equal JAX's exactly; the loaded
    leaves differ from the random start and the leaf counts are JAX's."""
    name, ckpt, ov = _CASES[case]
    jspec, tspec = _specs(name, checkpoints[ckpt], **ov)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    (_, b), = tspec.branches
    assert b.tower_norm == "batch"
    assert b.tower_deep_stem == ckpt.startswith("deep")
    _, start, jvars, tmodel, loaded = _loaded(jspec, tspec, checkpoints[ckpt])
    for what in ("params", "batch_stats"):
        got = flat_leaves(to_flax_tree(tmodel, what))
        want = flat_leaves(jvars[what])
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    trunk = "/".join(tpre.tower_param_path("branch_l0", b))
    assert trunk == "/".join(jpre.tower_param_path(jspec, 0, b))
    counts = tpre.tower_leaf_count(tmodel, tspec)
    assert counts == jpre.tower_leaf_count(jvars, jspec)
    assert loaded[trunk] == counts[trunk] > 0
    before, after = flat_leaves(start["params"]), flat_leaves(jvars["params"])
    moved = [k for k in before if k.startswith(trunk + "/")
             and not np.array_equal(before[k], after[k])]
    assert len(moved) == counts[trunk]
    head = "branch_l0/tower/PPM_0"
    assert (head in loaded) == (b.tower == "resnet18_ppm")
    if head in loaded:
        assert loaded[head] == sum(1 for k in before
                                   if k.startswith(head + "/")) == 15


def test_five_pyramid_branches_load_their_truncations(checkpoints):
    """The Cityscapes PointPyramid: five deep-stem truncations at level 0
    (``branch_l0``, ``branch_l0_1`` .. ``branch_l0_4``), each overlaid with
    the leaves of its truncation, the trees equal to JAX's."""
    jspec, tspec = _specs(PYRAMID, checkpoints["deep_ppm"])
    _, _, jvars, tmodel, loaded = _loaded(jspec, tspec,
                                          checkpoints["deep_ppm"], seed=1)
    names = ["branch_l0"] + [f"branch_l0_{k}" for k in range(1, 5)]
    assert list(loaded) == [f"{n}/tower" for n in names]
    # deep stem: 3 x (kernel, scale, bias); each layer 2 blocks x 6, + 3
    # for the first block's projection where it has one
    assert list(loaded.values()) == [9, 24, 39, 54, 69]
    for what in ("params", "batch_stats"):
        got = flat_leaves(to_flax_tree(tmodel, what))
        want = flat_leaves(jvars[what])
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["l1-torchvision", "ppm-deep-decoder"])
def test_loaded_towers_compute_what_jax_computes(checkpoints, case):
    """The loaded tower's eval-mode output on the tiny batch's images within
    1e-5 of JAX's (float32 operands)."""
    name, ckpt, ov = _CASES[case]
    jspec, tspec = _specs(name, checkpoints[ckpt], **ov)
    jmodel, _, jvars, tmodel, _ = _loaded(jspec, tspec, checkpoints[ckpt])
    images = jax_tiny_batch()[0]["images"]
    factory, _ = jseg.make_tower(tspec.branches[0][1].tower, "batch",
                                 tspec.branches[0][1].tower_deep_stem)
    jtower = factory(parent=None)
    tree = {c: jvars[c]["branch_l0"]["tower"]
            for c in ("params", "batch_stats")}
    with jt.f32_convs(), tt.f32_convs():
        ref = np.asarray(jax.jit(lambda v, x: jt.run_tower(
            jtower.bind(v), x, False, bf16=False))(tree, images))
        with torch.no_grad():
            got = tt.run_tower(tmodel.branch_l0.tower,
                               torch.from_numpy(images), False,
                               bf16=False).numpy()
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-5


def test_refusals_are_jax_ones(checkpoints):
    """A group-norm tower, a stem that is not the checkpoint's and a decoder
    of other widths raise the same ``ValueError`` in both packages."""
    name = "Res16UNet14-L1-early-group2"
    ov = dict(backbone="Res16UNetTest")
    cases = []
    # group-norm towers: the spec without tower_weights
    jspec = jzoo.get_model_spec(name, 4, 4, ov)
    tspec = tzoo.get_model_spec(name, 4, 4, ov)
    cases.append((jspec, tspec, checkpoints["torchvision"],
                  "tower_norm='batch'"))
    # a 7x7 tower, a deep-stem checkpoint (the stem pinned to False)
    jspec, tspec = _specs(name, checkpoints["deep_ppm"],
                          tower_deep_stem=False)
    cases.append((jspec, tspec, checkpoints["deep_ppm"], "stem does not"))
    # the PPM tower's 128-channel head, a 512-channel decoder
    jspec, tspec = _specs("Res16UNet14-early-group2-ppm",
                          checkpoints["deep_ppm512"])
    cases.append((jspec, tspec, checkpoints["deep_ppm512"], "shape mismatch"))
    batch, _ = jax_tiny_batch()
    for jspec, tspec, path, match in cases:
        jmodel = jseg.build_model(jspec)
        variables = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), batch, train=False))
        variables = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), variables)
        with pytest.raises(ValueError, match=match):
            jpre.apply_tower_weights(variables, jspec, path)
        tmodel = tseg.build_model(tspec, device="cpu", seed=None)
        with pytest.raises(ValueError, match=match):
            tpre.apply_tower_weights(tmodel, tspec, path)


def test_resolved_specs_are_jax_ones(checkpoints, tmp_path):
    """``resolve_spec_from_cfg`` with ``tower_weights``: the deep stem sniffed
    from the checkpoint (torchvision: none; MIT: ``conv3.weight``, under
    ``encoder.``), an ``overrides`` pin winning over the sniff, an
    unreadable path leaving the spec's own stem, ``tower_frozen`` alone
    and with weights; every spec JAX's field for field."""
    missing = str(tmp_path / "gone.pth")
    for kw in (
            dict(name="Res16UNet34-L4-early",
                 tower_weights=checkpoints["deep_ppm"]),
            dict(name="Res16UNet34-L2-intermediate-group8-imagenet",
                 tower_weights=checkpoints["torchvision"]),
            dict(name="Res16UNet34-L4-early",
                 tower_weights=checkpoints["torchvision_wrapped"],
                 tower_frozen=True),
            dict(name="Res16UNet34-L4-early",
                 tower_weights=checkpoints["deep_ppm"],
                 overrides={"tower_deep_stem": False}),
            dict(name="Res16UNet34-L4-early-ade20k-interpolate",
                 tower_weights=missing),
            dict(name="Res16UNet34-L4-early", tower_weights=missing),
            dict(name=PYRAMID, tower_weights=checkpoints["deep_ppm"]),
            dict(name="Res16UNet34-L4-early", tower_frozen=True)):
        got = tzoo.resolve_spec_from_cfg(trun.ModelCfg(**kw), 13)
        want = jzoo.resolve_spec_from_cfg(jrun.ModelCfg(**kw), 13)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
        norm = "batch" if kw.get("tower_weights") else "group"
        assert all(b.tower_norm == norm for _, b in got.branches)
    sniffed = tzoo.resolve_spec_from_cfg(trun.ModelCfg(
        name="Res16UNet34-L4-early", tower_weights=checkpoints["deep_ppm"]),
        13)
    assert sniffed.branches[0][1].tower_deep_stem


def test_state_dict_reader_skips_counters_and_wrappers(checkpoints):
    sd = tconv.load_torch_state_dict(checkpoints["torchvision_wrapped"])
    raw = resnet18_state_dict(seed=1)
    assert sorted(sd) == sorted(k for k in raw
                                if not k.endswith("num_batches_tracked"))
    for k, v in sd.items():
        assert torch.equal(v, raw[k])
    # the conv kernels take the [O, I, kw, kh] layout of the W-first maps
    c = tconv.convert_resnet18(sd, out_level=1)
    assert torch.equal(c["Conv2dWS_0.weight"],
                       raw["conv1.weight"].transpose(2, 3))
    assert "_BasicBlock2d_1._Norm_1.BatchNorm_0.running_var" in c
    assert not any(k.startswith("_BasicBlock2d_2") for k in c)


def test_cli_train_pins_the_stem_and_eval_restores_without_the_file(
        tmp_path, monkeypatch, capsys):
    """``cli.train --device cpu model.tower_weights=<deep-stem .pth>`` on a
    tiny synthetic run: it prints the leaves loaded, trains the BatchNorm
    tower (its running statistics move), and stores ``tower_deep_stem:
    true`` in ``run.json``; with the checkpoint deleted, ``cli.eval``
    rebuilds the same model from ``run.json`` and the saved weights."""
    f32_sparse_convs(monkeypatch)
    pth = write_resnet18_checkpoint(tmp_path / "mit.pth", deep_stem=True,
                                    ppm_channels=128, seed=4)
    run_dir = tmp_path / "run"
    start = {k: v for k, v in resnet18_state_dict(True, 128, 4).items()}
    trained = {}
    real_fit = cli_train.Trainer.fit

    def fit(self, *a, **k):
        out = real_fit(self, *a, **k)
        trained.update(self.model.state_dict())
        return out

    monkeypatch.setattr(cli_train.Trainer, "fit", fit)
    torch.set_num_threads(2)
    args = ["--device", "cpu", "data.dataset=synthetic",
            "data.voxel_size=0.15", "data.radius=1.5", "data.image_slots=2",
            "data.samples_per_epoch=4", "data.batch_size=2",
            "data.image_size=[64, 32]", "training.epochs=1",
            "training.tensorboard=false",
            "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}",
            "model.name=Res16UNet14-L1-early-group2",
            "model.overrides={backbone: Res16UNetTest, tower_bf16: false}",
            f"model.tower_weights={pth}", f"data.root={tmp_path / 'data'}",
            f"training.run_dir={run_dir}"]
    with tt.f32_convs():
        metrics = cli_train.main(args)
    assert np.isfinite(metrics["train_loss"])
    out = capsys.readouterr().out
    assert "loaded tower weights: {'branch_l0/tower': 24}" in out
    stored = json.loads((run_dir / "run.json").read_text())
    assert stored["model"]["overrides"]["tower_deep_stem"] is True
    assert stored["model"]["tower_weights"] == pth
    rm = trained["branch_l0.tower._Norm_0.BatchNorm_0.running_mean"]
    assert not torch.equal(rm, start["encoder.bn1.running_mean"])
    (tmp_path / "mit.pth").unlink()
    with tt.f32_convs():
        res = cli_eval.main(["--run_dir", str(run_dir), "--device", "cpu"])
    assert np.isfinite(res["test_miou"])
