"""The preprocessing entry points of the PyTorch port:
``cli.preprocess`` against the root ``scripts/preprocess.py`` on the
miniature S3DIS layout (``torch_port_util.fake_s3dis_layout``), shard by
shard, and against the caches ``cli.train`` builds in-line; and
``cli.scale_rehearsal`` at a small size on the CPU, its JSON line with the
JAX script's keys plus the device's.

As in ``test_torch_port_s3dis.py``: the host arrays of a cache are
byte-identical to the JAX package's, the normals and view features within
1e-4 (torch kNN / PCA), every mapping index array equal.  The port's own
in-line build and ``cli.preprocess`` give equal arrays, every one."""

import ast
import dataclasses
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from deepviewagg_tpu.data.datasets import base as jbase
from deepviewagg_tpu_torch.cli import preprocess as cli_pre
from deepviewagg_tpu_torch.cli import scale_rehearsal as cli_rehearsal
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import s3dis as ts
from deepviewagg_tpu_torch.data.datasets import synthetic_ds as tsyn
from torch_port_util import (_torch_threads, assert_identical,  # noqa: F401
                             fake_s3dis_layout)

ROOT = Path(__file__).resolve().parent.parent
HOST_KEYS = ("pos", "rgb", "labels", "origin_id", "images", "raw_pos",
             "raw_labels")
ARGS = ["--dataset", "s3dis", "--voxel-size", "0.1", "--image-size", "128",
        "64", "--keep-raw", "--num-shards", "2"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return fake_s3dis_layout(str(tmp_path_factory.mktemp("pre") / "raw"))


def _jax_script(argv):
    """``scripts/preprocess.py`` with ``argv``, as a user runs it."""
    old = sys.argv
    sys.argv = [str(ROOT / "scripts" / "preprocess.py"), *argv]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = old


def _mapping(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("shard", [0, 1])
def test_preprocess_shard_matches_the_jax_script(layout, tmp_path, shard):
    """One shard of two: the same areas (the i-th of the sorted listing
    goes to shard i % 2), each cache as the JAX script's."""
    jout, tout = tmp_path / "j", tmp_path / "t"
    _jax_script([*ARGS, "--root", layout, "--out", str(jout),
                 "--shard", str(shard)])
    written = cli_pre.main([*ARGS, "--root", layout, "--out", str(tout),
                            "--shard", str(shard), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == [f"area_{(1, 5)[shard]}"
                                                      ".npz"]
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    for path in written:
        ref = jbase.load_area(str(jout / os.path.basename(path)))
        got = tbase.load_area(path)
        assert sorted(ref) == sorted(got)
        for key in HOST_KEYS:
            assert_identical(np.asarray(ref[key]), np.asarray(got[key]), key)
        assert np.abs(ref["normal"] - got["normal"]).max() <= 1e-4
        rm, gm = _mapping(ref["mapping"]), _mapping(got["mapping"])
        for name in rm:
            if name == "view_feats":
                assert np.abs(rm[name] - gm[name]).max() <= 1e-4
            else:
                assert_identical(rm[name], gm[name], name)


def _equal_caches(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for name in names:
        if not name.endswith(".npz"):
            continue
        a, b = np.load(a_dir / name, allow_pickle=True), np.load(
            b_dir / name, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert_identical(a[key], b[key], f"{name}/{key}")
        side = name[:-4] + "_images.npy"
        if (a_dir / side).exists():
            assert np.array_equal(np.load(a_dir / side),
                                  np.load(b_dir / side))


def test_preprocess_equals_the_in_line_build(layout, tmp_path):
    """Both shards of ``cli.preprocess`` give the caches that the S3DIS
    loader of ``cli.train`` builds in-line with the same options, array for
    array."""
    tout = tmp_path / "cli"
    for shard in (0, 1):
        cli_pre.main([*ARGS, "--root", layout, "--out", str(tout),
                      "--shard", str(shard), "--device", "cpu"])
    inline = tmp_path / "inline"
    for train in (True, False):
        ts.make_s3dis_dataset(layout, train=train, voxel_size=0.1,
                              cache_dir=str(inline), image_size=(128, 64),
                              keep_raw=True, device="cpu")
    _equal_caches(tout, inline)


def test_synthetic_preprocess_equals_the_in_line_build(tmp_path):
    cli_pre.main(["--dataset", "synthetic", "--root", str(tmp_path),
                  "--out", str(tmp_path / "cli"), "--device", "cpu"])
    tsyn.build_synthetic_cache(str(tmp_path / "inline"), device="cpu")
    _equal_caches(tmp_path / "cli", tmp_path / "inline")


def _jax_rehearsal_keys():
    """The keys of the JAX script's JSON line, read from its source."""
    tree = ast.parse((ROOT / "scripts" / "scale_rehearsal.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "out" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        elif isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant)
                and k.value in ("target_points", "t_scene_s")
                for k in node.keys):
            keys |= {k.value for k in node.keys}
    return keys


def test_scale_rehearsal_json_line(capsys):
    out = cli_rehearsal.main(["--points", "1e4", "--cameras", "2", "--image",
                              "64", "32", "--getitems", "3", "--device",
                              "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    want = _jax_rehearsal_keys()
    assert len(want) == 20
    assert set(out) == want | {"device", "device_peak_mem_mb"}
    assert out["device"] == "cpu" and out["device_peak_mem_mb"] == 0.0
    assert out["full_res_points"] == out["raw_points"] > 0.9 * 1e4
    assert out["voxels"] > 0 and out["views"] > 0 and out["pixels"] > 0
    assert out["getitem_mean_s"] > 0 and out["cache_mb"] > 0
