"""Run configuration and model zoo of the PyTorch port against the JAX
package.

The port reads YAML with its own reader (the card's machine has no PyYAML):
it must give what ``yaml.safe_load`` gives on every ``conf/*.yaml`` and on
override literals, and ``load_run_config`` must give the JAX package's
``to_dict()`` exactly.  Zoo names resolve to specs equal to the JAX specs
field for field (``dataclasses.asdict``).  Everything compared exactly.
"""

import dataclasses
import glob
import os
import warnings

import pytest
import yaml

from deepviewagg_tpu.config import run as jrun
from deepviewagg_tpu.config import zoo as jzoo
from deepviewagg_tpu_torch.config import run as trun
from deepviewagg_tpu_torch.config import zoo as tzoo
from deepviewagg_tpu_torch.config.yaml_subset import safe_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(ROOT, "conf", "*.yaml")))
CONF_IDS = [os.path.basename(p) for p in CONFS]

OVERRIDE_LITERALS = [
    "[]", "[1024, 512]", "{n_areas: 2}", "{n_areas: 2, density: 30.0}",
    "{a: [1, {b: null}], c: 'x, y'}", "[[1, 2], [3]]", "{}", "1e-4",
    "0.0001", "10.0", "-3", "+7", "0", "017", "0x1f", "0b101", "1_000",
    "3.", ".5", "1.5e+3", ".inf", "-.inf", "true", "False", "yes", "off",
    "null", "~", "", "Res16UNet34-L4-early-ade20k-interpolate", "synthetic",
    "/tmp/dva runs/x", "'quoted: x'", '"a\\"b"', "'it''s'", "a#b",
    "abc # a comment", "s3dis_fold5",
]

OVERRIDE_SETS = [
    [],
    ["training.epochs=3", "training.lr_milestones=[]", "data.batch_size=2",
     "data.kwargs={n_areas: 2, density: 30.0}", "model.overrides={backbone: "
     "Res16UNetTest}", "training.grad_clip=null", "data.image_size=[64, 32]",
     "training.resume=true", "training.weight_decay=0.0"],
]


@pytest.mark.parametrize("path", CONFS, ids=CONF_IDS)
def test_yaml_reader_matches_pyyaml_on_conf_files(path):
    with open(path) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("literal", OVERRIDE_LITERALS)
def test_yaml_reader_matches_pyyaml_on_override_literals(literal):
    got, want = safe_load(literal), yaml.safe_load(literal)
    assert got == want and type(got) is type(want)


def test_yaml_reader_nested_blocks_and_comments():
    text = ("# header\na:\n  b:\n    c: 1   # trailing\n\n    d: [x, 'y #z']\n"
            "  e:\nf: \"q\"\n")
    assert safe_load(text) == yaml.safe_load(text) == {
        "a": {"b": {"c": 1, "d": ["x", "y #z"]}, "e": None}, "f": "q"}


@pytest.mark.parametrize("text", [
    # block sequences are read since the reference-YAML ingest (see
    # test_torch_port_yaml_blocks.py); a misindented one is refused
    "a:\n  - 1\n   - 2\n", "a: &x 1\n", "a: !!str 1\n", "a: |\n  text\n",
    "a: 2024-01-01\n", "a: 1:30\n", "a: [1, 2\n", "a:\n   b: 1\n  c: 2\n",
    "---\na: 1\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        safe_load(text)


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFS, ids=CONF_IDS)
def test_load_run_config_matches_jax(path, overrides):
    got = trun.load_run_config(path, list(overrides)).to_dict()
    want = jrun.load_run_config(path, list(overrides)).to_dict()
    assert got == want


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=["plain", "overrides"])
def test_defaults_with_overrides_match_jax(overrides):
    """No YAML file: the dataclass defaults, then the overrides."""
    got = trun.load_run_config(None, list(overrides)).to_dict()
    want = jrun.load_run_config(None, list(overrides)).to_dict()
    assert got == want


def test_unknown_keys_and_data_ref_raise():
    with pytest.raises(KeyError):
        trun.load_run_config(None, ["training.nope=1"])
    with pytest.raises(ValueError):
        trun.load_run_config(None, ["training.epochs"])
    # data.ref ingests a reference data YAML: a missing file raises, as in
    # the JAX package
    for mod in (trun, jrun):
        with pytest.raises(FileNotFoundError, match="data.ref"):
            mod.load_run_config(None, ["data.ref=/nonexistent/s3dis.yaml"])


# --- the zoo -----------------------------------------------------------------

GRAMMAR = [
    "Res16UNet14-L1-early-group4-interpolate",       # the Quick start model
    "Res16UNet34-L2-intermediate-group8-imagenet-interpolate",
    "Res16UNet34-L3-intermediate2-max",
    "Res16UNet18-L4-intermediate3-mean-cityscapes",
    "Res16UNet34-early-heuristic-ppm-interpolate",
    "Res16UNet34-L0-early-qkv-scratch",
    "Res16UNet34-L4-early-group-nogating-interpolate",
    "Res16UNet34-L4-early-group4-drop30-interpolate",
    "Res16UNet34-L4-early-group4-harddrop50",
    "Res16UNet14A-L1-late-group2",
    "Res16UNet34C-L4-intermediate4-ade20k-nogating-drop10-interpolate",
    "Res16UNet34", "Res16UNet50", "SERes16UNet34", "Res16UNetTest",
]


def _assert_same_spec(name, num_classes=13, in_channels=4, overrides=None):
    got = tzoo.get_model_spec(name, num_classes, in_channels, overrides)
    want = jzoo.get_model_spec(name, num_classes, in_channels, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


@pytest.mark.parametrize("name", sorted(jzoo._NAMED))
def test_named_entries_match_jax(name):
    _assert_same_spec(name)
    assert tzoo._NAMED[name] == jzoo._NAMED[name]


@pytest.mark.parametrize("name", GRAMMAR)
def test_grammar_names_match_jax(name):
    assert tzoo.parse_model_name(name) == jzoo.parse_model_name(name)
    _assert_same_spec(name, num_classes=4, in_channels=7)


def test_overrides_match_jax():
    spec = _assert_same_spec(
        "Res16UNet34-L4-early-ade20k-interpolate", 4, 4,
        {"backbone": "Res16UNetTest", "tower_bf16": False, "stem_kernel": 5})
    assert spec.backbone == "Res16UNetTest" and spec.stem_kernel == 5
    assert not spec.branches[0][1].tower_bf16


@pytest.mark.parametrize("field", [
    f.name for f in dataclasses.fields(tzoo.ModelSpec)])
@pytest.mark.parametrize("name", ["Res16UNet34-L4-early-ade20k-interpolate",
                                  "Res16UNet34"])
def test_head_dropout_override_is_the_one_difference_from_jax(name, field):
    """A ``head_dropout`` override on a zoo name, once the one difference
    between the packages' specs: now every field of the port's spec,
    ``head_dropout`` included, is the JAX spec's (both ``_to_spec`` drop the
    key and keep 0.0)."""
    got = dataclasses.asdict(tzoo.get_model_spec(name, 13, 4,
                                                 {"head_dropout": 0.5}))
    want = dataclasses.asdict(jzoo.get_model_spec(name, 13, 4,
                                                  {"head_dropout": 0.5}))
    assert got[field] == want[field]
    if field == "head_dropout":
        assert got[field] == 0.0


def test_bad_names_raise_like_jax():
    for mod in (tzoo, jzoo):
        with pytest.raises(KeyError):
            mod.get_model_spec("NotAModel-L9", 4)
        with pytest.raises(ValueError):
            mod.get_model_spec("Res16UNet34-L4-early-group4-drop99", 4)
    # ref: names ingest a reference YAML entry: a missing file or entry is
    # a KeyError naming the files searched, as in the JAX package
    for mod in (tzoo, jzoo):
        with pytest.raises(KeyError, match="not found for"):
            mod.get_model_spec("ref:nosuchfile/Res16UNet21-15_light", 4)


def _model_cfg(**kw):
    return trun.ModelCfg(**kw)


def test_resolve_spec_from_cfg_matches_jax():
    for kw in (dict(name="Res16UNet14-L1-early-group4-interpolate"),
               dict(name="Res16UNet34-L4-early", tower_frozen=True),
               dict(name="Res16UNet14", overrides={"stem_kernel": 5})):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = tzoo.resolve_spec_from_cfg(_model_cfg(**kw), 13)
        want = jzoo.resolve_spec_from_cfg(jrun.ModelCfg(**kw), 13)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert all(b.frozen for _, b in tzoo.resolve_spec_from_cfg(
        _model_cfg(name="Res16UNet34-L4-early", tower_frozen=True), 13).branches)


def test_pretrained_token_warns_and_tower_weights_raise():
    with pytest.warns(UserWarning, match="FROM SCRATCH"):
        spec = tzoo.resolve_spec_from_cfg(
            _model_cfg(name="Res16UNet34-L4-early-ade20k-interpolate"), 13)
    assert spec.branches[0][1].tower_deep_stem
    # tower_weights resolves as in the JAX package: BatchNorm towers, the
    # stem of a checkpoint that cannot be read left as the spec has it
    kw = dict(name="Res16UNet34-L4-early", tower_weights="/x/ade20k.pth")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tzoo.resolve_spec_from_cfg(_model_cfg(**kw), 13)
    want = jzoo.resolve_spec_from_cfg(jrun.ModelCfg(**kw), 13)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [b.tower_norm for _, b in got.branches] == ["batch"]
