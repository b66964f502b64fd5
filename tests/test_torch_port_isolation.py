"""The PyTorch port stands alone: no module of ``deepviewagg_tpu_torch``
imports JAX, flax or the JAX package, nor PIL, PyYAML or torchvision (the
card's machine has none of them: the port reads PNGs, JPEGs and YAML
itself), and its entry points default to the card."""

import ast
import inspect
from pathlib import Path

import pytest

import deepviewagg_tpu_torch

PKG = Path(deepviewagg_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepviewagg_tpu")
NOT_ON_THE_CARD = ("PIL", "torchvision", "yaml")
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_pil_or_torchvision_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in NOT_ON_THE_CARD]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", ["utils/image_io.py",
                                 "data/datasets/s3dis.py",
                                 "core/visibility.py"])
def test_s3dis_modules_are_covered(rel):
    """The S3DIS loader's files exist, are among the files the import
    checks walk, and read images with the standard library and numpy."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel == "utils/image_io.py":
        assert roots <= {"__future__", "math", "struct", "typing", "zlib",
                         "numpy"}


@pytest.mark.parametrize("rel", ["data/datasets/scannet.py",
                                 "core/cameras.py", "core/visibility.py",
                                 "data/mapping_factory.py",
                                 "utils/image_io.py", "utils/ply.py"])
def test_scannet_modules_are_covered(rel):
    """The ScanNet loader's files (its cameras, visibility methods and JPEG
    reader) exist, are among the files the import checks walk, import
    neither package's counterpart nor PIL, and the image reader keeps to
    the standard library and numpy."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel.startswith("utils/"):
        assert roots <= {"__future__", "math", "struct", "typing", "zlib",
                         "numpy"}


@pytest.mark.parametrize("rel", ["data/datasets/kitti360.py",
                                 "data/datasets/base.py",
                                 "modules/image_encoders.py",
                                 "models/segmentation.py",
                                 "config/yaml_subset.py", "cli/train.py",
                                 "cli/eval.py"])
def test_kitti360_modules_are_covered(rel):
    """The KITTI-360 path's files (its loader, the camera-family eval
    credit, the pyramid towers, the YAML reader of the fisheye calibration,
    the CLIs) are among the files the import checks walk and import neither
    package's counterpart nor PIL or PyYAML; the loader reads its YAML with
    the port's own reader."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel == "data/datasets/kitti360.py":
        assert "yaml_subset" in path.read_text()


def test_kitti360_entry_points_default_to_the_card():
    from deepviewagg_tpu_torch.data.datasets import kitti360

    for fn in (kitti360.preprocess_kitti360_window,
               kitti360.make_kitti360_dataset):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_scannet_entry_points_default_to_the_card():
    from deepviewagg_tpu_torch.data.datasets import scannet

    for fn in (scannet.preprocess_scannet_scan,
               scannet.make_scannet_dataset):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_no_camera_model_or_visibility_method_refuses():
    """No camera model and no visibility method raises
    ``NotImplementedError`` any more."""
    for rel in ("core/cameras.py", "core/visibility.py",
                "data/mapping_factory.py"):
        assert "NotImplementedError" not in (PKG / rel).read_text(), rel


def test_training_modules_are_covered():
    covered = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    for rel in ("train/__init__.py", "train/optimizers.py", "train/step.py",
                "models/losses.py", "ops/segment.py", "ops/sparse_conv.py",
                "nn/norm.py", "utils/from_jax.py"):
        assert rel in covered, rel
    assert (PKG / "csrc" / "segment_csr_bwd.cu").exists()


@pytest.mark.parametrize("rel", [
    "config/run.py", "config/yaml_subset.py", "config/zoo.py",
    "data/transforms2d.py", "data/transforms3d.py",
    "data/datasets/base.py", "data/datasets/synthetic_ds.py",
    "metrics/confusion.py", "metrics/tracker.py", "train/checkpoint.py",
    "train/trainer.py", "utils/logging.py", "cli/train.py"])
def test_experiment_loop_modules_are_covered(rel):
    """The experiment-loop files exist, are among the files the import
    check walks, and import neither package's counterpart, nor PyYAML (the
    card's machine has none), nor the root ``train.py``."""
    path = PKG / rel
    assert path in sorted(PKG.rglob("*.py"))
    roots = {name for name, _ in _imported_roots(path)}
    assert not roots & (set(FORBIDDEN) | {"yaml", "train"})


@pytest.mark.parametrize("rel", [
    "cli/eval.py", "cli/predict.py", "data/inference_transform.py",
    "utils/ply.py"])
def test_eval_and_predict_modules_are_covered(rel):
    """The evaluation and prediction files exist, are among the files the
    import check walks, and import neither package's counterpart, nor
    PyYAML, nor the root ``eval.py`` / ``predict.py`` / ``train.py``."""
    path = PKG / rel
    assert path in sorted(PKG.rglob("*.py"))
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN)
                                  | {"yaml", "eval", "predict", "train"})


@pytest.mark.parametrize("rel", ["data/crop_groups.py",
                                 "modules/multibucket.py"])
def test_crop_ladder_modules_are_covered(rel):
    """The crop-ladder files exist, are among the files the import check
    walks, and import neither package's counterpart."""
    path = PKG / rel
    assert path in sorted(PKG.rglob("*.py"))
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & set(FORBIDDEN)
    assert roots <= {"__future__", "typing", "numpy", "torch"}


def test_ladder_path_leaves_the_kernel_wrappers_alone(monkeypatch):
    """On CPU tensors a ladder forward and backward take the plain versions
    and launch nothing; the wrappers' dtype checks hold for what
    ``batch_to_torch`` ships (int32 ``ptr``, bool ``valid``)."""
    import torch

    from deepviewagg_tpu_torch.data.collate import batch_to_torch
    from deepviewagg_tpu_torch.data.toy import flagship_spec, recipe_batch
    from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
    from deepviewagg_tpu_torch.ops import segment as seg

    torch.set_num_threads(2)
    np_batch, bucket, _ = recipe_batch(
        n_samples=1, density=20.0, image_size=(64, 32), n_cameras=1,
        voxel_size=0.15, min_size=16, device="cpu")
    assert [tuple(s) for s in bucket.image_ladder] == [(32, 16), (64, 32)]
    batch = batch_to_torch(np_batch, device="cpu")
    model = MultimodalSeg(flagship_spec(backbone="Res16UNetTest",
                                        tower="resnet18_l1", num_groups=2),
                          device="cpu", seed=0).train()
    kinds = []
    plain = seg.segment_csr_plain
    monkeypatch.setattr(seg, "segment_csr_plain", lambda x, p, v, r: kinds.append(
        (r, p.dtype, None if v is None else v.dtype)) or plain(x, p, v, r))
    before = dict(seg.LAUNCHES)
    model(batch)["logits"].sum().backward()
    assert seg.LAUNCHES == before
    # an atomic pool per bucket, then the view pool's five reductions
    assert len(kinds) == 2 + 5
    assert all(p == torch.int32 and v in (None, torch.bool)
               for _, p, v in kinds)


def test_cpu_tensors_take_the_plain_backward_and_never_launch(monkeypatch):
    import torch

    from deepviewagg_tpu_torch.ops import segment as seg

    calls = []
    plain = seg.segment_csr_bwd_plain
    monkeypatch.setattr(seg, "segment_csr_bwd_plain",
                        lambda *a, **k: calls.append(a[5]) or plain(*a, **k))
    x = torch.arange(12.0).reshape(6, 2).requires_grad_()
    ptr = torch.tensor([0, 2, 2, 6], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True, True])
    before = dict(seg.LAUNCHES)
    for reduce in ("sum", "max"):
        seg.segment_csr(x, ptr, valid, reduce).sum().backward()
    assert calls == ["sum", "max"]
    assert seg.LAUNCHES == before
    # sum: 1 on the 5 valid rows; max: 1 on rows 1 and 5 (the segment maxima)
    want = torch.tensor([[1.0], [2.0], [1.0], [0.0], [1.0], [2.0]]).expand(6, 2)
    assert torch.equal(x.grad, want)


def test_segment_csr_raises_instead_of_falling_back():
    import torch

    from deepviewagg_tpu_torch.ops import segment as seg

    x = torch.zeros(4, 2)
    ptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    g = torch.zeros(2, 2)
    # a type the kernels do not take: no conversion, no plain-version detour
    for bad in (x.double(), x.to(torch.bfloat16)):
        with pytest.raises(TypeError, match="float32"):
            seg.segment_csr(bad, ptr, None, "sum")
    with pytest.raises(TypeError, match="float32"):
        seg.segment_csr_bwd(g.double(), None, None, ptr, None, "sum", 4)
    with pytest.raises(TypeError, match="int32"):
        seg.segment_csr(x, ptr.long(), None, "sum")
    # a device that is neither the CPU nor a card
    with pytest.raises(RuntimeError, match="unsupported device"):
        seg.segment_csr(x.to("meta"), ptr.to("meta"), None, "max")
    with pytest.raises(RuntimeError, match="unsupported device"):
        seg.segment_csr_bwd(g.to("meta"), None, None, ptr.to("meta"), None,
                            "sum", 4)
    with pytest.raises(ValueError):
        seg.segment_csr_bwd(g, None, None, ptr, None, "max", 4)


def test_entry_points_default_to_the_card():
    from deepviewagg_tpu_torch.cli import train as cli
    from deepviewagg_tpu_torch.data import collate, geometric, mapping_factory, toy
    from deepviewagg_tpu_torch.data.datasets import s3dis, synthetic_ds
    from deepviewagg_tpu_torch.data.inference_transform import ModelInference
    from deepviewagg_tpu_torch.metrics.tracker import VoteAccumulator
    from deepviewagg_tpu_torch.models import segmentation

    for fn in (toy.toy_batch, toy.toy_samples, toy.recipe_batch,
               mapping_factory.build_mappings,
               geometric.pca_features, collate.batch_to_torch,
               segmentation.MultimodalSeg.__init__,
               segmentation.SparseConv3dSeg.__init__,
               segmentation.build_model, synthetic_ds.build_synthetic_cache,
               synthetic_ds.make_synthetic_dataset, cli.build_dataset,
               s3dis.preprocess_s3dis_area, s3dis.make_s3dis_dataset,
               ModelInference.__init__, VoteAccumulator.full_res_preds):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("entry", ["train", "eval", "predict", "preprocess",
                                   "scale_rehearsal", "train_task",
                                   "demo_synthetic"])
def test_cli_device_flags_default_to_the_card(entry):
    """Each CLI's ``--device`` defaults to ``cuda``."""
    import importlib

    mod = importlib.import_module(f"deepviewagg_tpu_torch.cli.{entry}")
    tree = ast.parse(inspect.getsource(mod))
    defaults = [kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--device"
                for kw in node.keywords if kw.arg == "default"]
    assert defaults == ["cuda"]


@pytest.mark.parametrize("rel", [
    "modules/scratch2d.py", "modules/pooling.py", "modules/branch.py",
    "modules/image_encoders.py", "modules/multibucket.py",
    "models/segmentation.py", "models/losses.py", "ops/segment.py",
    "utils/from_jax.py", "train/step.py", "cli/train.py", "cli/eval.py",
    "config/zoo.py"])
def test_model_family_modules_are_covered(rel):
    """The files of the no3d and late-fusion families, the view pools and
    the scratch towers are among the files the import checks walk and
    import neither package's counterpart; the scratch stack keeps its own
    copy of ``tower_cfg_out_channels`` and imports only the standard
    library and torch."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel == "modules/scratch2d.py":
        assert roots <= {"__future__", "math", "typing", "torch"}
        assert "def tower_cfg_out_channels" in path.read_text()


def test_model_families_default_to_the_card():
    from deepviewagg_tpu_torch.models import segmentation

    for fn in (segmentation.No3DSeg.__init__,
               segmentation.LateFusionSeg.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("rel", [
    "config/reference_ingest.py", "config/yaml_subset.py", "config/zoo.py",
    "config/run.py", "models/segmentation.py", "modules/image_encoders.py",
    "modules/branch.py", "modules/multibucket.py", "utils/from_jax.py",
    "cli/preprocess.py", "cli/scale_rehearsal.py"])
def test_reference_ingest_modules_are_covered(rel):
    """The reference-YAML ingest, the ingest-only branch kinds and the
    preprocessing entry points are among the files the import checks walk
    and import neither JAX nor the JAX package (not even its numpy-only
    modules) nor PyYAML; the ingest reads YAML with the port's own
    reader."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel == "config/reference_ingest.py":
        assert "from .yaml_subset import safe_load" in path.read_text()


def test_no_refusal_of_the_segmentation_path_remains():
    """No ``NotImplementedError`` is left in the port (the trainer's
    parallelism and sample dumps, ROADMAP A.7 and A.9, are ported); none
    names the ingest or the ingest-only branches (A.2.3, A.6)."""
    left = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
            if "NotImplementedError" in p.read_text()}
    assert left == set(), left
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        assert "ROADMAP A.2.3" not in text and "ROADMAP A.6" not in text, p


@pytest.mark.parametrize("rel", [
    "parallel/collectives.py", "parallel/multihost.py", "parallel/mesh.py",
    "nn/norm.py", "train/step.py", "train/trainer.py", "cli/train.py",
    "visualization/viewer.py"])
def test_parallel_modules_are_covered(rel):
    """The data / view parallel modules and the sample dump are among the
    files the import checks walk; the collectives keep to torch, and the
    dump writes its PLY with the port's writer."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    if rel == "parallel/collectives.py":
        assert roots <= {"__future__", "typing", "torch"}
    if rel == "visualization/viewer.py":
        assert "from ..utils.ply import write_ply" in path.read_text()


TASK_MODULES = ["ops/spatial.py", "nn/pointnet2.py", "ops/sparse_conv.py",
                "models/classification.py", "models/detection.py",
                "models/panoptic.py", "models/registration.py",
                "metrics/detection.py", "data/datasets/tasks.py",
                "train/task_steps.py", "cli/train_task.py"]


@pytest.mark.parametrize("rel", TASK_MODULES)
def test_task_modules_are_covered(rel):
    """The non-segmentation tasks' files exist, are among the files the
    import checks walk, and import neither JAX nor the JAX package (not even
    its numpy-only metrics or dataset code) nor PyYAML; the numpy-only
    metrics keep to numpy."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    assert "NotImplementedError" not in path.read_text()
    if rel == "metrics/detection.py":
        assert roots <= {"__future__", "typing", "numpy"}


def test_task_models_default_to_the_card():
    from deepviewagg_tpu_torch.models import (classification, detection,
                                              panoptic, registration)
    from deepviewagg_tpu_torch.nn import pointnet2
    from deepviewagg_tpu_torch.train import task_steps

    for fn in (classification.SparseConv3dCls.__init__,
               detection.VoteNetDet.__init__, panoptic.PanopticSeg.__init__,
               registration.RegistrationNet.__init__,
               pointnet2.PointNet2Seg.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    fields = {f.name: f.default for f in
              task_steps.TaskTrainer.__dataclass_fields__.values()}
    assert fields["device"] == "cuda"


# the point backbones and the kNN helpers (ROADMAP A.9): each with the JAX
# module's public names
BACKBONE_MODULES = ["nn/pointnet.py", "nn/pvcnn.py", "nn/kpconv.py",
                    "nn/rsconv.py", "nn/pointcnn.py", "nn/ppnet.py",
                    "nn/randlanet.py", "ops/knn.py"]


def _public_names(path: Path) -> set:
    """The names a module lists in ``__all__``, read without importing it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return {ast.literal_eval(e) for e in node.value.elts}
    return set()


@pytest.mark.parametrize("rel", BACKBONE_MODULES)
def test_point_backbone_modules_are_covered(rel):
    """The point backbones' and the kNN helpers' files exist, are among the
    files the import checks walk, import neither JAX nor the JAX package,
    refuse nothing, and offer every public name of their JAX counterpart
    (``deepviewagg_tpu/<rel>``), each bound to a definition."""
    import importlib

    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    assert "NotImplementedError" not in path.read_text()
    want = _public_names(ROOT / "deepviewagg_tpu" / rel)
    got = _public_names(path)
    assert want and want <= got, sorted(want - got)
    mod = importlib.import_module(
        "deepviewagg_tpu_torch." + rel[:-3].replace("/", "."))
    assert all(callable(getattr(mod, name)) for name in got)


def test_nn_package_imports_what_the_jax_one_does():
    """``deepviewagg_tpu_torch/nn/__init__.py`` imports the submodules the
    JAX package's ``nn/__init__.py`` imports."""
    def submodules(path):
        return {alias.name for node in ast.parse(path.read_text()).body
                if isinstance(node, ast.ImportFrom) and node.level == 1
                for alias in node.names}

    want = submodules(ROOT / "deepviewagg_tpu" / "nn" / "__init__.py")
    assert want and submodules(PKG / "nn" / "__init__.py") == want


@pytest.mark.parametrize("name", ["pointnet.PointNetSeg",
                                  "pointnet.PointNetCls", "pvcnn.PVCNNSeg",
                                  "kpconv.KPConvSeg", "rsconv.RSConvSeg",
                                  "pointcnn.PointCNNSeg", "ppnet.PPNetSeg",
                                  "randlanet.RandLANetSeg"])
def test_point_backbones_default_to_the_card(name):
    import importlib

    mod, cls = name.split(".")
    model = getattr(importlib.import_module(f"deepviewagg_tpu_torch.nn.{mod}"),
                    cls)
    assert inspect.signature(model.__init__).parameters[
        "device"].default == "cuda"


# --- the last slice: native builders, the viewer and demo, the helpers and
# transforms (ROADMAP A.5, A.9.1-A.9.3) ---------------------------------------

# JAX public names the port has no counterpart for, each with its reason
NOT_TO_PORT = {
    ("modules/image_encoders.py", "view_shard_axis"):
        "a shard_map axis name; the port shards views over a process group "
        "(run_tower's view_shard_group, parallel/mesh.py)",
    ("nn/norm.py", "bn_axis_name"):
        "a shard_map axis name; sync batch norm takes a process group "
        "(bn_process_group)",
    ("parallel/mesh.py", "stack_batches"):
        "stacks per-device batches for shard_map; each rank holds its own",
    ("train/step.py", "optax_global_norm"):
        "optax's tree norm; the port's optimizer is its own "
        "(train/optimizers.py::global_norm)",
    ("utils/pretrained.py", "iter_branches"):
        "a flax parameter-path walk; the port loads each branch by its "
        "module name (apply_tower_weights)",
    ("modules/scratch2d.py", "TowerCfg"):
        "a typing alias",
    ("ops/pallas_segment.py", "pallas_available"):
        "Pallas's switch; a wrapper launches the CUDA kernel on a card "
        "tensor and its plain version on a CPU tensor",
    ("ops/pallas_segment.py", "INTERPRET"):
        "Pallas's interpret-mode flag",
    ("ops/pallas_segment.py", "R"):
        "the Pallas kernel's row tile; the CUDA kernel has its own",
    ("native/__init__.py", "lib"):
        "the CPython extension object; the port's native module exposes "
        "its functions",
}
# a JAX module whose counterpart in the port has another path, and names
# that the counterpart offers under another name
COUNTERPART = {"ops/pallas_segment.py": "ops/segment.py"}
RENAMED = {("ops/pallas_segment.py", "segment_sum_pallas"): "segment_csr",
           ("ops/pallas_segment.py", "segment_max_pallas"): "segment_csr"}


def _top_level_names(path: Path, imports: bool) -> set:
    """Module-level names without a leading underscore: functions, classes
    and assignments (and, with ``imports``, imported names)."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(ROOT / "deepviewagg_tpu"))
                     for p in (ROOT / "deepviewagg_tpu").rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_its_counterpart(rel):
    """Every module-level public name of every JAX module (functions,
    classes, constants) is defined or imported by the port's module at the
    same path, but the listed exceptions, each with its reason."""
    port = PKG / COUNTERPART.get(rel, rel)
    assert port.exists(), f"no counterpart of {rel}"
    have = _top_level_names(port, imports=True)
    missing = set()
    for name in _top_level_names(ROOT / "deepviewagg_tpu" / rel, False):
        if (rel, name) in NOT_TO_PORT:
            continue
        if RENAMED.get((rel, name), name) not in have:
            missing.add(name)
    assert not missing, sorted(missing)


def test_each_exception_is_still_a_jax_name_the_port_lacks():
    for (rel, name), reason in NOT_TO_PORT.items():
        assert reason
        assert name in _top_level_names(ROOT / "deepviewagg_tpu" / rel,
                                        False), (rel, name)
        port = PKG / COUNTERPART.get(rel, rel)
        assert not port.exists() or name not in _top_level_names(
            port, imports=True), (rel, name)


@pytest.mark.parametrize("rel", [
    "native/__init__.py", "ops/voxel.py", "ops/kernel_map.py",
    "ops/sparse_graph.py", "ops/knn.py", "data/geometric.py",
    "visualization/viewer.py", "cli/demo_synthetic.py", "core/csr.py",
    "ops/sparse_conv.py", "metrics/confusion.py", "utils/logging.py",
    "data/transforms3d.py", "utils/cuda_build.py"])
def test_last_slice_modules_are_covered(rel):
    """The native builders' files, the viewer and demo, the helpers' and
    the transforms' modules are among the files the import checks walk,
    import neither JAX nor the JAX package nor PIL, and refuse nothing; the
    native module reaches its library through the shared build helper, and
    the viewer encodes its PNGs with the port's own writer."""
    path = PKG / rel
    assert path in PORT_FILES
    roots = {name for name, _ in _imported_roots(path)}
    assert roots and not roots & (set(FORBIDDEN) | set(NOT_ON_THE_CARD))
    assert "NotImplementedError" not in path.read_text()
    if rel == "native/__init__.py":
        assert 'cuda_build.load("kernelmap")' in path.read_text()
        assert roots <= {"__future__", "ctypes", "numpy"}
    if rel == "visualization/viewer.py":
        assert "from ..utils.image_io import encode_png" in path.read_text()


def test_host_builders_need_no_numpy_fallback():
    """The port's voxel hash, kernel maps and PCA reach the native library;
    the numpy versions are reached from nowhere in the package but their
    own plain chain."""
    plain = ("unique_coords_plain", "query_coords_plain",
             "build_kernel_map_plain", "_build_padded_map_plain")
    callers = {}
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for name in plain:
            if f"{name}(" in text.replace(f"def {name}(", ""):
                callers.setdefault(name, set()).add(
                    str(path.relative_to(PKG)))
    # build_kernel_map_plain calls query_coords_plain, and the padded map's
    # plain version calls build_kernel_map_plain
    assert callers == {"query_coords_plain": {"ops/kernel_map.py"},
                       "build_kernel_map_plain": {"ops/sparse_graph.py"}}
    assert "DVA_NO_NATIVE" not in (PKG / "native" / "__init__.py").read_text()


def test_the_slice_defaults_to_the_card():
    from deepviewagg_tpu_torch.data import transforms3d

    for cls in (transforms3d.RandomWalkDropout, transforms3d.DensityFilter):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
