"""Reference-YAML ingest in the PyTorch port against the JAX package, on a
conf tree in the upstream's DSL that the tests write
(``torch_port_refconf.py``): ``load_model_spec`` field for field on every
entry (shared trunk, tower reuse, raw RGB, the flagship, the PointPyramid,
late feature / logit, no3d feature and scratch-UNet logit entries, an
inline custom plan, a pure-3D and two ``minkowski.`` entries),
``load_data_cfg`` on a data file with a ``defaults:`` base and
interpolations, ``get_model_spec("ref:...")`` and ``load_run_config(...,
["data.ref=..."])`` under ``DVA_REFERENCE_CONF`` /
``DVA_REFERENCE_DATA_CONF``, and the errors.  The upstream's own published
files are not in the repository; parity on them waits for them."""

import dataclasses
import os

import pytest

from deepviewagg_tpu.config import reference_ingest as jri
from deepviewagg_tpu.config import run as jrun
from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu_torch.config import reference_ingest as tri
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.config import zoo as tzoo
from torch_port_refconf import write_reference_conf

MODEL_FILES = {
    "sparseconv3d": "models/segmentation/multimodal/sparseconv3d.yaml",
    "no3d": "models/segmentation/multimodal/no3d.yaml",
    "sparseconv3d_3d": "models/segmentation/sparseconv3d.yaml",
    "minkowski_baseline": "models/segmentation/minkowski_baseline.yaml",
}
ENTRIES = [
    ("sparseconv3d", "Res16UNet34-L4-early-ade20k-interpolate"),
    ("sparseconv3d", "Res16UNet14-Res16Image-max"),
    ("sparseconv3d", "Res16UNet14-L4-all"),
    ("sparseconv3d", "Res16UNet14-RGB-identity-early"),
    ("sparseconv3d",
     "Res16UNet34-PointPyramid-early-cityscapes-interpolate"),
    ("sparseconv3d", "Res16UNet21-15-custom"),
    ("sparseconv3d", "XYZ-RGB-PPM-late"),
    ("sparseconv3d", "XYZ-RGB-L4-late-logit-QKV"),
    ("no3d", "RGB_ResNet18PPM_g4_MinMaxDiffSetFeat"),
    ("no3d", "RGB_UNet-light-logit-drop"),
    ("sparseconv3d_3d", "Res16UNet14-3D"),
    ("minkowski_baseline", "MinkUNet14A"),
    ("minkowski_baseline", "MinkUNet34C"),
]
DATA = "data/segmentation/multimodal/s3disfused-sparse.yaml"


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    return write_reference_conf(tmp_path_factory.mktemp("ref"))


@pytest.fixture
def ref_env(conf, monkeypatch):
    monkeypatch.setenv("DVA_REFERENCE_CONF", str(conf / "models/segmentation"))
    monkeypatch.setenv("DVA_REFERENCE_DATA_CONF",
                       str(conf / "data/segmentation/multimodal"))
    return conf


def _fields(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("val,constants,feat", [
    ("4*in_feat", {"in_feat": 32, "l4": 512}, None),
    ("FEAT + l4", {"in_feat": 32, "l4": 512}, 1),
    (7, {}, None),
    (["l4", "2*in_feat"], {"in_feat": 32, "l4": 512}, None),
    ("N_CLS", {}, 13),
    ("mystery", {}, None),
    ("__import__('os')", {}, None),
    ("(in_feat + 1) / 2", {"in_feat": 31}, None),
    (None, {}, None),
])
def test_resolve_constant_matches_jax(val, constants, feat):
    got = tri.resolve_constant(val, constants, feat)
    assert got == jri.resolve_constant(val, constants, feat)
    if val == "__import__('os')":
        assert got == val          # the fullmatch guard: left as a string


@pytest.mark.parametrize("file,name", ENTRIES,
                         ids=[n for _, n in ENTRIES])
def test_model_entry_matches_jax(conf, file, name):
    path = str(conf / MODEL_FILES[file])
    ncls = 13
    got = tri.load_model_spec(path, name, ncls, 4)
    want = jri.load_model_spec(path, name, ncls, 4)
    assert type(got).__module__.startswith("deepviewagg_tpu_torch")
    assert _fields(got) == _fields(want)


def test_branch_kinds_of_the_entries(conf):
    """What the three ingest-only branch kinds resolve to."""
    path = str(conf / MODEL_FILES["sparseconv3d"])
    shared = tri.load_model_spec(path, "Res16UNet14-Res16Image-max", 13)
    assert shared.shared_tower == ((32, 32, 64, 128, 256), (0, 2, 2, 2, 2),
                                   (1, 2, 2, 2, 2))
    assert [(lvl, b.tower, b.out_channels) for lvl, b in shared.branches] \
        == [(i, f"shared:{i}", w)
            for i, w in enumerate((32, 32, 64, 128, 256))]
    reuse = tri.load_model_spec(path, "Res16UNet14-L4-all", 13)
    assert [(lvl, b.tower, b.out_channels, b.fusion_mode)
            for lvl, b in reuse.branches] == [
        (0, "resnet18_l4", 64, "concat"), (1, "reuse", 32, "residual"),
        (3, "reuse", 64, "residual")]
    raw = tri.load_model_spec(path, "Res16UNet14-RGB-identity-early", 13)
    assert [(lvl, b.tower, b.out_channels) for lvl, b in raw.branches] == [
        (0, None, 3)]


def test_flagship_entry_is_the_zoo_spec(conf):
    """The flagship entry ingests to the zoo's spec of its name but for
    ``drop_hard`` (upstream never threads it: False), which does nothing
    at the entry's zero dropout."""
    got = tri.load_model_spec(str(conf / MODEL_FILES["sparseconv3d"]),
                              "Res16UNet34-L4-early-ade20k-interpolate", 13)
    zoo = tzoo.get_model_spec("Res16UNet34-L4-early-ade20k-interpolate", 13)
    (_, b), = got.branches
    assert not b.drop_hard and b.drop_modality == b.drop_3d == 0.0
    assert dataclasses.replace(got, branches=((0, dataclasses.replace(
        b, drop_hard=True)),)) == zoo


def test_data_cfg_matches_jax(conf):
    path = str(conf / DATA)
    got = tri.load_data_cfg(path)
    assert got == jri.load_data_cfg(path)
    # the base's sample_per_epoch under the child's own keys, and the
    # interpolations resolved
    assert got["samples_per_epoch"] == 3000 and got["voxel_size"] == 0.05
    assert got["image_size"] == [64, 32] and got["crop_ladder_min"] == 16
    assert got["image_slots"] == 2 and got["eval_image_slots"] == 3
    assert got["radius"] == 1.5
    mp = got["kwargs"]["mapping_params"]
    assert mp["exact"] is True and mp["r_max"] == 8.0
    assert mp["proj_upscale"] == 2 and mp["crop_padding"] == 8
    ap = got["kwargs"]["aug_params"]
    assert ap["k_coverage"] == 2 and ap["use_bbox"] is True
    assert got["kwargs"]["fold"] == 5


def test_yaml_doc_memo(conf, tmp_path):
    """One parse per (path, mtime); a rewritten file is read again."""
    path = tmp_path / "m.yaml"
    path.write_text("a:\n    - 1\n")
    first = tri.load_yaml_doc(str(path))
    assert tri.load_yaml_doc(str(path)) is first
    path.write_text("a:\n    - 2\n")
    os.utime(path, (1, 1))
    assert tri.load_yaml_doc(str(path)) == {"a": [2]}
    with pytest.raises(KeyError):
        tri.load_model_entry(str(path), "b")


def test_unresolvable_stride_raises():
    for mod in (tri, jri):
        with pytest.raises(ValueError, match="unresolvable stride"):
            mod._stage_strides({"down_conv_nn": [[4, 8], [8, 16]],
                                "stride": [1, "mystery_s"]}, {})


def test_refused_yaml_surfaces(tmp_path):
    """A form the reader refuses raises; nothing is guessed."""
    path = tmp_path / "anchors.yaml"
    path.write_text("base: &b\n    class: x\nentry: *b\n")
    with pytest.raises(ValueError):
        tri.load_model_spec(str(path), "entry", 13)


@pytest.mark.parametrize("name,overrides", [
    ("ref:sparseconv3d/Res16UNet14-Res16Image-max", None),
    ("ref:sparseconv3d/Res16UNet14-L4-all", {"backbone": "Res16UNetTest",
                                             "tower_bf16": False}),
    ("ref:sparseconv3d/Res16UNet14-3D", None),     # the pure-3D file
    ("ref:no3d/RGB_UNet-light-logit-drop", {"head_dropout": 0.5}),
    ("ref:minkowski_baseline/MinkUNet14A", {"stem_kernel": 3}),
])
def test_ref_names_match_jax(ref_env, name, overrides):
    got = tzoo.get_model_spec(name, 13, 4, overrides)
    assert _fields(got) == _fields(jzoo.get_model_spec(name, 13, 4,
                                                       overrides))
    if overrides:
        # ModelSpec fields apply; others (a branch's tower_bf16) do not
        for k, v in overrides.items():
            if hasattr(got, k):
                assert getattr(got, k) == v


def test_ref_name_errors(ref_env):
    with pytest.raises(KeyError, match="not found for .*sparseconv3d.yaml"):
        tzoo.get_model_spec("ref:sparseconv3d/NoSuchEntry", 13)
    with pytest.raises(KeyError, match=r"searched \[\]"):
        tzoo.get_model_spec("ref:nofile/Entry", 13)


def test_ref_name_through_resolve_spec_from_cfg(ref_env):
    cfg = trun.ModelCfg(name="ref:sparseconv3d/Res16UNet14-RGB-identity-early",
                        overrides={"stem_kernel": 3})
    spec = tzoo.resolve_spec_from_cfg(cfg, 13)
    assert spec == tzoo.get_model_spec(cfg.name, 13, 4, cfg.overrides)


@pytest.mark.parametrize("overrides", [
    ["data.ref=s3disfused-sparse"],
    ["data.ref=s3disfused-sparse", "data.image_slots=5",
     "data.kwargs.fold=2", "data.kwargs.keep_raw=true"],
    ["data.ref=s3disfused-sparse.yaml", "data.crop_ladder_min=0"],
])
def test_data_ref_matches_jax(ref_env, overrides):
    got = trun.load_run_config(None, overrides).to_dict()
    assert got == jrun.load_run_config(None, overrides).to_dict()
    assert got["data"]["dataset"] == "s3dis"
    assert got["data"]["kwargs"]["mapping_params"]["r_max"] == 8.0
    if "data.image_slots=5" in overrides:
        assert got["data"]["image_slots"] == 5          # the CLI wins
        assert got["data"]["kwargs"]["fold"] == 2       # the user's kwargs
        assert got["data"]["kwargs"]["keep_raw"] is True
        assert got["data"]["eval_image_slots"] == 3     # ingested


def test_data_ref_whole_kwargs_override_replaces_them(ref_env):
    """As in the JAX package, a whole ``data.kwargs={...}`` override is
    applied again after the ingest and replaces the ingested kwargs (the
    dotted ``data.kwargs.<key>=`` form merges)."""
    ov = ["data.ref=s3disfused-sparse", "data.kwargs={fold: 2}"]
    got = trun.load_run_config(None, ov).to_dict()
    assert got == jrun.load_run_config(None, ov).to_dict()
    assert got["data"]["kwargs"] == {"fold": 2}


def test_data_ref_by_path_and_missing(ref_env):
    path = str(ref_env / DATA)
    got = trun.load_run_config(None, [f"data.ref={path}"]).to_dict()
    assert got == jrun.load_run_config(None, [f"data.ref={path}"]).to_dict()
    with pytest.raises(FileNotFoundError, match="nosuch"):
        trun.load_run_config(None, ["data.ref=nosuch"])
