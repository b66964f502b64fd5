"""The prediction path of the PyTorch port against the JAX package: the PLY
reader and writer, ``ModelInference`` on a 3D-only checkpoint and the
``cli.predict`` entry point (root ``predict.py``).

The two packages' checkpoint files are not interchangeable: each run dir is
written by its own ``CheckpointManager`` under the same ``run.json``, from
one set of flax variables (converted for the port by
``utils/from_jax.py::load_flax_variables``).  The sparse convolutions of
both run with float32 operands (``f32_sparse_convs``), so the forwards agree
to float32 noise: logits within 1e-5 relative, probabilities within 1e-6,
labels equal (the test asserts that no voxel's two largest logits lie within
1e-4 of each other).  PLY files are byte-identical.
"""

import os

import numpy as np
import pytest
import torch

import predict as jax_predict_cli
from deepviewagg_tpu.config.run import load_run_config as jax_load_run_config
from deepviewagg_tpu.config.zoo import resolve_spec_from_cfg as jax_resolve
from deepviewagg_tpu.data import collate as jcollate
from deepviewagg_tpu.data.inference_transform import \
    ModelInference as JaxModelInference
from deepviewagg_tpu.models.segmentation import build_model as jax_build_model
from deepviewagg_tpu.train import checkpoint as jckpt
from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu.train import step as jstep
from deepviewagg_tpu.utils import ply as jply
from deepviewagg_tpu_torch.cli import predict as cli
from deepviewagg_tpu_torch.config.zoo import resolve_spec_from_cfg
from deepviewagg_tpu_torch.data.inference_transform import ModelInference
from deepviewagg_tpu_torch.models.segmentation import build_model
from deepviewagg_tpu_torch.train import checkpoint as tckpt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils import ply as tply
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import (_torch_threads, f32_sparse_convs,  # noqa: F401
                             jax_variables, rel_err)

RUN = ["model.name=Res16UNetTest", "data.num_classes=4",
       "data.voxel_size=0.2"]
N_POINTS = 600


def _cloud(seed=1, n=N_POINTS):
    rng = np.random.default_rng(seed)
    return {"pos": (rng.random((n, 3)) * 2.5).astype(np.float32),
            "rgb": rng.random((n, 3)).astype(np.float32)}


def _write_runs(root, overrides, variables=None):
    """A JAX and a port run dir of one config; the checkpoint (``latest``)
    holds ``variables`` (random flax variables when None) in each package's
    format.  Returns ``(jax_dir, port_dir, variables)``."""
    cfg = jax_load_run_config(None, overrides)
    run_config = cfg.to_dict()
    jspec = jax_resolve(cfg.model, cfg.data.num_classes)
    if variables is None:
        rng = np.random.default_rng(0)
        n = 300
        sample = jcollate.Sample(
            coords=(rng.random((n, 3)) * 12).astype(np.int32),
            feats=rng.random((n, 4)).astype(np.float32),
            labels=rng.integers(0, 4, n).astype(np.int32))
        bucket = jcollate.Bucket(level_caps=[512, 256, 256, 256, 256],
                                 num_batches=1)
        batch = jcollate.device_view(jcollate.collate(
            [sample], bucket, conv0_kernel=jspec.stem_kernel))
        variables = jax_variables(jax_build_model(jspec), batch, train=False)
    jdir, tdir = os.path.join(root, "jax_run"), os.path.join(root, "port_run")
    jckpt.CheckpointManager(jdir, dict(run_config)).save_state(
        "latest", jstep.TrainState.create(
            variables, jopt.make_optimizer(jopt.make_schedule("constant",
                                                              0.1))))
    tspec = resolve_spec_from_cfg(cfg.model, cfg.data.num_classes)
    if not tspec.branches and tspec.in_channels == 4:
        model = build_model(tspec, device="cpu", seed=None)
        load_flax_variables(model, variables)
        state = tstep.TrainState.create(model, topt.make_optimizer(
            topt.make_schedule("constant", 0.1)))
    else:
        state = None
    ckpt = tckpt.CheckpointManager(tdir, dict(run_config))
    if state is not None:
        ckpt.save_state("latest", state)
    return jdir, tdir, variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both run dirs, and the JAX ``ModelInference``'s logits, probabilities
    and labels on ``_cloud()`` (one JAX instance, one compiled program)."""
    root = str(tmp_path_factory.mktemp("predict"))
    jdir, tdir, variables = _write_runs(root, RUN)
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        infer = JaxModelInference(jdir, feat_name="f", output="logits")
        ref = {}
        for output in ("logits", "probs", "labels"):
            infer.output = output
            ref[output] = infer(_cloud())
        assert len(infer._programs) == 1
    return {"root": root, "jax": jdir, "port": tdir, "ref": ref,
            "variables": variables}


# --- PLY ---------------------------------------------------------------------

def _fields(kind, n=37, seed=0):
    rng = np.random.default_rng(seed)
    xyz = {k: rng.normal(size=n).astype(np.float32) for k in "xyz"}
    if kind == "xyz":
        return xyz
    if kind == "colors_labels":
        return {**xyz, **{c: rng.integers(0, 256, n).astype(np.uint8)
                          for c in ("red", "green", "blue")},
                "label": rng.integers(-1, 13, n).astype(np.int32)}
    return {"a": rng.normal(size=n), "b": rng.integers(-9, 9, n).astype(
        np.int16), "c": rng.integers(0, 9, n).astype(np.uint16),
            "d": rng.integers(-9, 9, n).astype(np.int8),
            "e": rng.integers(0, 9, n).astype(np.uint32)}


@pytest.mark.parametrize("kind", ["xyz", "colors_labels", "all_types"])
def test_write_ply_byte_identical(tmp_path, kind):
    fields = _fields(kind)
    jply.write_ply(str(tmp_path / "j.ply"), fields)
    tply.write_ply(str(tmp_path / "t.ply"), fields)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def _assert_same_fields(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kind", ["xyz", "colors_labels", "all_types"])
def test_read_ply_reads_jax_files(tmp_path, kind):
    fields = _fields(kind)
    path = str(tmp_path / "j.ply")
    jply.write_ply(path, fields)
    got = tply.read_ply(path)
    _assert_same_fields(got, jply.read_ply(path))
    _assert_same_fields(got, fields)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_read_ply_skips_other_elements(tmp_path, fmt):
    """An ascii or binary file with a face element of index lists after the
    vertices, and one before: both readers give the same vertex arrays."""
    verts = np.array([(0.5, -1.0, 2.0, 7), (1.5, 0.25, -3.0, 9)],
                     dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                            ("label", "<i4")])
    header = ("ply\nformat {fmt} 1.0\ncomment made by hand\n"
              "element {first} {n_first}\n{props_first}"
              "element {second} {n_second}\n{props_second}end_header\n")
    vprops = ("property float x\nproperty float y\nproperty float z\n"
              "property int label\n")
    fprops = "property list uchar int vertex_indices\n"
    for faces_first in (False, True):
        parts = [("vertex", 2, vprops), ("face", 1, fprops)]
        if faces_first:
            parts.reverse()
        (first, n1, p1), (second, n2, p2) = parts
        head = header.format(fmt=fmt, first=first, n_first=n1,
                             props_first=p1, second=second, n_second=n2,
                             props_second=p2).encode()
        if fmt == "ascii":
            vbody = b"0.5 -1.0 2.0 7\n1.5 0.25 -3.0 9\n"
            fbody = b"3 0 1 1\n"
        else:
            vbody = verts.tobytes()
            fbody = np.uint8(3).tobytes() + np.array([0, 1, 1], "<i4").tobytes()
        body = fbody + vbody if faces_first else vbody + fbody
        path = tmp_path / f"{fmt}_{faces_first}.ply"
        path.write_bytes(head + body)
        got = tply.read_ply(str(path))
        _assert_same_fields(got, jply.read_ply(str(path)))
        for k in ("x", "y", "z", "label"):
            assert np.array_equal(got[k], verts[k])


# --- ModelInference ----------------------------------------------------------

def test_model_inference_matches_jax(runs):
    ref = runs["ref"]
    logits = ref["logits"]["f"]
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        infer = ModelInference(runs["port"], feat_name="f", device="cpu")
        for output in ("logits", "probs", "labels"):
            infer.output = output
            got = infer(_cloud())
            want = ref[output]
            assert sorted(got) == sorted(want)
            for k in ("pos", "coords", "rgb"):
                assert np.array_equal(got[k], want[k]), k
            g, w = got["f"], want["f"]
            assert g.dtype == w.dtype and g.shape == w.shape
            if output == "logits":
                assert g.shape == (len(got["coords"]), 4)
                assert rel_err(g, w) <= 1e-5
            elif output == "probs":
                assert np.abs(g - w).max() <= 1e-6
            else:
                assert np.array_equal(g, w)
    assert next(infer.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("case", ["multimodal", "in_channels", "no_run_json"])
def test_model_inference_refusals(runs, tmp_path, case):
    if case == "no_run_json":
        jdir = tdir = str(tmp_path)
        err = FileNotFoundError
    else:
        extra = (["model.name=Res16UNet14-L1-early-group2"]
                 if case == "multimodal" else ["model.in_channels=3"])
        jdir, tdir, _ = _write_runs(str(tmp_path), RUN + extra,
                                    runs["variables"])
        err = ValueError
    with pytest.raises(err) as want:
        JaxModelInference(jdir)
    with pytest.raises(err) as got:
        ModelInference(tdir, device="cpu")
    assert str(got.value) == str(want.value)


# --- cli.predict -------------------------------------------------------------

def _write_inputs(root):
    """The same cloud as ``.npz`` (rgb in [0, 255]) and as ``.ply``."""
    cloud = _cloud(seed=2)
    rgb = np.round(cloud["rgb"] * 255).astype(np.uint8)
    npz = os.path.join(root, "cloud.npz")
    np.savez(npz, pos=cloud["pos"], rgb=rgb.astype(np.float32))
    ply = os.path.join(root, "cloud.ply")
    tply.write_ply(ply, {"x": cloud["pos"][:, 0], "y": cloud["pos"][:, 1],
                         "z": cloud["pos"][:, 2], "red": rgb[:, 0],
                         "green": rgb[:, 1], "blue": rgb[:, 2]})
    return npz, ply


def test_predict_cli_matches_jax(runs, tmp_path):
    npz, ply = _write_inputs(str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        f32_sparse_convs(mp)
        want = str(tmp_path / "jax.ply")
        jax_predict_cli.main(["--run_dir", runs["jax"], "--input", npz,
                              "--output", want])
        outputs = [cli.main(["--run_dir", runs["port"], "--input", path,
                             "--device", "cpu", "--output",
                             str(tmp_path / f"port_{i}.ply")])
                   for i, path in enumerate((npz, ply))]
    ref = tply.read_ply(want)
    assert len(ref["label"]) > 100 and len(np.unique(ref["label"])) > 1
    for path in outputs:
        got = tply.read_ply(path)
        # labels, class colours and voxel positions: the same file
        assert open(path, "rb").read() == open(want, "rb").read()
        assert np.array_equal(got["label"], ref["label"])


def test_predict_pins_tf32_and_defaults_to_the_card(runs, tmp_path,
                                                    monkeypatch):
    npz, _ = _write_inputs(str(tmp_path))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cli.main(["--run_dir", runs["port"], "--input", npz, "--device", "cpu"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--run_dir", runs["port"], "--input", npz])
