"""The port's YAML reader on the forms of the reference's published Hydra
/ Torch-Points3D files: block sequences (of scalars, flow values, mappings
and sequences, also at the key's column), sequences nested in sequences,
flow collections over several lines and plain scalars such as
``${data.resolution_2d}`` and ``FEAT + l4``.  Each text reads as PyYAML's
``safe_load`` reads it (PyYAML only here, never in the port); the forms the
reader does not take raise ``ValueError``, also where PyYAML reads them,
and never read differently."""

import pytest
import yaml

from deepviewagg_tpu_torch.config.yaml_subset import safe_load
from torch_port_refconf import FILES

READ = {
    "scalars": "- a\n- 1\n- 0x1f\n- 2.5\n- ~\n- [1, 2]\n- {a: 1}\n",
    "defaults": "defaults:\n- /data/segmentation/kitti360-sparse\n\n"
                "class: x\nfold: 5\n",
    "defaults_indented": "defaults:\n    - /data/x\n    - /data/y\nk: 1\n",
    "transform_chain": (
        "train_transforms:\n"
        "    - transform: RandomNoise\n"
        "      params:\n"
        "          sigma: 0.001\n"
        "    - transform: XYZFeature\n"
        "    - transform: AddFeatsByKeys\n"
        "      params:\n"
        "          list_add_to_x: [True, True]\n"
        "          feat_names: [rgb, pos_z]\n"),
    "nested_compact": "- - a\n  - b\n- -\n    - c\n- []\n",
    "nested_block": "a:\n  -\n    - 1\n    - 2\n  - - 3\n",
    "flow_lines": (
        "down_conv_nn:\n"
        "    [\n"
        "        [FEAT + mod_in_feat, in_feat],\n"
        "        [in_feat, 2*in_feat],  # a comment\n"
        "    ]\n"
        "N: [0, 2, 3, 4, 6]\n"),
    "flow_lines_open": ("up_conv_nn: [[8*in_feat + 4*in_feat, 4*in_feat],\n"
                        "   [a, b]]\nx: 1\n"),
    "flow_map_lines": "a: {x: 1,\n  y: [1,\n 2]}\n",
    "interpolations": "resolution_2d: ${data.resolution_2d}\n"
                      "n: ${data.multimodal.settings.k}\n",
    "arithmetic": "in_mod: FEAT + l4\nk: 4*in_feat\nq: 'x: y'\n",
    "item_mappings": "- a: 1\n  b:\n  - x\n  - y\n- c: 2\n",
    "item_columns": "-   a: 1\n    b: 2\n-   c: 3\n",
    "empty_items": "- \n- x\n-\n",
    "key_sequence_then_key": "a:\n    b:\n    - 1\n    - 2\n    c: 3\n",
    "comments": "# head\na:   # trailing\n  - 1   # one\n  # between\n  - 2\n",
}

# forms PyYAML reads that the reader refuses, and forms both refuse
REFUSED = {
    "anchor_alias": "a: &x 1\nb: *x\n",
    "item_anchor": "- &x a\n",
    "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  x\n",
    "folded_scalar": "a: >\n  x\n",
    "plain_over_lines": "a: one\n  two\n",
    "item_over_lines": "- abc\n  def\n",
    "document_marker": "---\na: 1\n",
    "two_documents": "a: 1\n...\nb: 2\n",
    "misindented_item": "a:\n  - x\n   - y\n",
    "brace_in_flow_scalar": "r: [${data.a}]\n",
    "item_after_mapping": "a: 1\n- b\n",
    "unclosed_flow": "a: [1, 2\nb: 3\n",
    "complex_key": "? a\n: 1\n",
}


@pytest.mark.parametrize("name", sorted(READ))
def test_reads_as_pyyaml(name):
    text = READ[name]
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("rel", sorted(FILES))
def test_fixture_conf_files_read_as_pyyaml(rel):
    """Each file of the reference conf tree the ingest tests write."""
    assert safe_load(FILES[rel]) == yaml.safe_load(FILES[rel])


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_forms_raise(name):
    with pytest.raises(ValueError):
        safe_load(REFUSED[name])
