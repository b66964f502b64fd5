"""Shared helpers of the ``test_torch_port_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port on the CPU.  The
module imports JAX only inside the helpers that need it, so that the
``card`` tests import it on a machine without JAX."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.models.losses import segmentation_loss
from deepviewagg_tpu_torch.ops import segment as seg

TINY_SPEC = dict(backbone="Res16UNetTest", tower="resnet18_l1", num_groups=2)
TINY_BATCH = dict(n_samples=1, density=25.0, image_size=(64, 32), n_cameras=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Tier-1 runs several workers at once: keep torch to two threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import): the
    fixture of the ``card``-marked tests, which skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def jax_tiny_batch():
    """The JAX package's tiny flagship batch (the ``__graft_entry__``
    ``_build(tiny=True)`` request): ``(numpy batch without meta, samples)``."""
    from deepviewagg_tpu.data.toy import toy_batch

    batch, _, samples = toy_batch(**TINY_BATCH)
    return {k: v for k, v in batch.items() if k != "meta"}, samples


def torch_batch(np_batch):
    return batch_to_torch(np_batch, device="cpu")


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Random flax variables of ``module`` applied to ``args``: fan-in-scaled
    normal kernels and non-trivial norm scales, biases and running
    statistics (see :func:`randomize_variables`).  Built from
    ``jax.eval_shape``: a real flax ``init`` of a model costs a minute on the
    CPU."""
    import jax

    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.normal(size=v.shape)
                          * np.sqrt(2.0 / fan_in)).astype(np.float32)
            else:
                out[k] = np.zeros(v.shape, np.float32)
        return out

    return randomize_variables(walk(shapes), seed)


@functools.lru_cache(maxsize=None)
def _model_variables(module, seed):
    return jax_variables(module, jax_tiny_batch()[0], seed=seed, train=False)


def jax_model_variables(module, seed: int = 0):
    """:func:`jax_variables` of a JAX model on the tiny batch (cached)."""
    return _model_variables(module, seed)


def randomize_variables(variables, seed: int = 0):
    """Non-trivial norm scales / biases and running statistics, so eval-mode
    norms are far from the identity; kernels are kept."""
    rng = np.random.default_rng(seed + 1)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = rng.normal(0.0, 0.2, v.shape)
            elif k == "mean":
                v = rng.normal(0.0, 0.3, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "weight":          # Gating
                v = rng.uniform(0.5, 1.5, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(variables)


def f32_sparse_convs(monkeypatch):
    """Make the sparse convolutions of both packages' blocks use float32
    operands instead of bf16-rounded ones, as ``f32_convs`` does for the
    towers.  With bf16 operands, a summation-order difference of 1e-7 in
    one layer flips the bf16 rounding of about 2.4e-4 of the next layer's
    operands by one ulp (2^-8), so a chain of layers drifts to 1e-4 .. 2e-3
    relative although every layer agrees to 1e-6; in float32 the chains
    agree to 1e-6."""
    import jax.numpy as jnp

    from deepviewagg_tpu.nn import sparse_blocks as jb
    from deepviewagg_tpu_torch.nn import sparse_blocks as tb

    j_plain, j_subm, j_pair = (jb.sparse_conv, jb.sparse_conv_submanifold,
                               jb.sparse_conv_pair)
    monkeypatch.setattr(jb, "sparse_conv", lambda f, w, n, bias=None, compute_dtype=None:
                        j_plain(f, w, n, bias=bias, compute_dtype=jnp.float32))
    monkeypatch.setattr(jb, "sparse_conv_submanifold", lambda f, w, n, cd=None:
                        j_subm(f, w, n, jnp.float32))
    monkeypatch.setattr(jb, "sparse_conv_pair", lambda f, w, n, nt, cd=None:
                        j_pair(f, w, n, nt, jnp.float32))
    t_plain, t_subm, t_pair = (tb.sparse_conv, tb.sparse_conv_submanifold,
                               tb.sparse_conv_pair)
    monkeypatch.setattr(tb, "sparse_conv", lambda f, w, n, bias=None, compute_dtype=None:
                        t_plain(f, w, n, bias, torch.float32))
    monkeypatch.setattr(tb, "sparse_conv_submanifold", lambda f, w, n, cd=None:
                        t_subm(f, w, n, torch.float32))
    monkeypatch.setattr(tb, "sparse_conv_pair", lambda f, w, n, nt, cd=None:
                        t_pair(f, w, n, nt, torch.float32))


def segment_case(seed, e=700, s=120, c=16, one_d=False, empty_tail=False):
    """Sorted segment ids with a masked drop segment ``s - 1``, some empty
    segments and (when ``empty_tail``) segments whose rows are all masked:
    ``(x [e, c] or [e], ids, valid, ptr, s)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s // 2 if empty_tail else s - 1, e)
    drop = rng.random(e) < 0.15
    ids = np.where(drop, s - 1, ids)
    valid = ~drop
    if empty_tail:
        valid &= ids % 7 != 3           # every 7th segment fully masked
    order = np.argsort(ids, kind="stable")
    ids, valid = ids[order].astype(np.int32), valid[order]
    x = rng.normal(size=(e,) if one_d else (e, c)).astype(np.float32)
    ptr = np.searchsorted(ids, np.arange(s + 1)).astype(np.int32)
    return x, ids, valid, ptr, s


# --- the sorted-segment kernels against their plain versions (the card
# tests and chip_smoke.py) ---------------------------------------------------

SUM_RTOL = 1e-5                    # kernel vs plain: only summation order
# the benchmark request (bench.py's forward batch): 4 samples, density 260,
# 12 images of 256 x 128
SERVE_REQUEST = dict(n_samples=4, density=260.0, image_size=(256, 128),
                     n_cameras=3)
# sorted-segment launches of the flagship: atomic max, set-encoder max, one
# count, one compatibility max, softmax sum, weighted sum; the count has no
# gradient
FORWARD_LAUNCHES, BACKWARD_LAUNCHES = 6, 5


def check_call(x, ptr, valid, reduce) -> float:
    """Forward kernel against plain on one input: max bit for bit, sum
    within ``SUM_RTOL``, the same bits on two runs, or it raises; returns
    the largest absolute difference."""
    got = seg.segment_csr(x, ptr, valid, reduce)
    if not torch.equal(got, seg.segment_csr(x, ptr, valid, reduce)):
        raise AssertionError("segment_csr: two runs gave different bits")
    ref = seg.segment_csr_plain(x, ptr, valid, reduce)
    if got.shape != ref.shape:
        raise AssertionError(f"segment_csr shape {tuple(got.shape)}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if reduce == "max":
        if not torch.equal(got, ref):
            raise AssertionError(f"segment_csr max differs: {err}")
    elif got.numel() and rel_err(got, ref) > SUM_RTOL:
        raise AssertionError(f"segment_csr sum differs: {rel_err(got, ref)}")
    return err


def check_bwd_call(g, x, out, ptr, valid, reduce, num_rows) -> float:
    """Backward kernel against plain on one input: bit for bit or it
    raises; returns the largest absolute difference (0.0)."""
    got = seg.segment_csr_bwd(g, x, out, ptr, valid, reduce, num_rows)
    ref = seg.segment_csr_bwd_plain(g, x, out, ptr, valid, reduce, num_rows)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if got.shape != ref.shape or not torch.equal(got, ref):
        raise AssertionError(f"segment_csr_bwd {reduce} differs: {err}")
    return err


def record_segment_calls(model, batch) -> list:
    """Every ``segment_csr`` call of one forward without gradient: ``(x,
    ptr, valid, reduce)``, cloned."""
    calls, inner = [], seg.segment_csr

    def recorder(x, ptr, valid, reduce):
        calls.append((x.clone(), ptr.clone(),
                      None if valid is None else valid.clone(), reduce))
        return inner(x, ptr, valid, reduce)

    seg.segment_csr = recorder
    try:
        with torch.no_grad():
            model(batch)
    finally:
        seg.segment_csr = inner
    return calls


def record_backward_calls(model, batch) -> list:
    """Every ``segment_csr_bwd`` call of one forward and backward of the
    segmentation loss: ``(g, x, out, ptr, valid, reduce, num_rows)`` as the
    autograd function hands them over (the cotangent cloned)."""
    calls, inner = [], seg.segment_csr_bwd

    def recorder(g, x, out, ptr, valid, reduce, num_rows=None):
        calls.append((g.clone(), x, out, ptr, valid, reduce, num_rows))
        return inner(g, x, out, ptr, valid, reduce, num_rows)

    seg.segment_csr_bwd = recorder
    try:
        out = model(batch)
        segmentation_loss(out["logits"], batch["labels"],
                          batch["graph"]["levels"][0]["valid"]).backward()
    finally:
        seg.segment_csr_bwd = inner
    model.zero_grad(set_to_none=True)
    return calls


def backward_node_names(t):
    """Type names of every node in the autograd graph below tensor ``t``."""
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def flat_leaves(tree, prefix=()):
    """``{"a/b/leaf": leaf}`` of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def assert_identical(a, b, path=""):
    """Same structure; arrays of the same dtype, shape and bytes; mappings
    and samples field by field (the two packages' classes differ)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_identical(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_identical(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def rel_err(a, b) -> float:
    """Largest absolute difference over the largest magnitude of ``b``
    (numpy arrays, or two tensors on any device)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- crop-ladder batches ----------------------------------------------------

LADDER = [(8, 4), (16, 8), (32, 16), (64, 32)]


def window_image(sample, image: int, x0: int, y0: int, x1: int, y1: int):
    """``sample`` with the mapped pixels of its image ``image`` masked out
    where they lie outside the window ``[x0, x1] x [y0, y1]``, so that the
    image's crop falls into a smaller size of the ladder.  Views left without
    a pixel stay in the view table."""
    import dataclasses

    m = sample.mapping
    img = m.image_id[np.minimum(m.pix_view, m.view_capacity - 1)]
    inside = ((m.pix_x >= x0) & (m.pix_x <= x1)
              & (m.pix_y >= y0) & (m.pix_y <= y1))
    keep = m.pix_valid & ((img != image) | inside)
    return dataclasses.replace(
        sample, mapping=dataclasses.replace(m, pix_valid=keep))


@functools.lru_cache(maxsize=None)
def jax_ladder_samples():
    """Two JAX-package samples of two 64 x 32 images each; the first image
    of either sample is windowed so that its crop falls into the (32, 16) and
    the (16, 8) size of ``LADDER``; nothing falls into (8, 4)."""
    from deepviewagg_tpu.data.toy import toy_samples

    a, b = toy_samples(2, 30.0, (64, 32), 2, 0.15, 0)
    return (window_image(a, 0, 10, 5, 33, 16),
            window_image(b, 0, 40, 20, 51, 26))


def ladder_bucket(samples, bucket_cls, voxel_mod, families: bool = False):
    """A crop-ladder ``Bucket`` (of either package) sized from the samples;
    the (8, 4) size gets no image slot unless ``families`` routes images
    there."""
    views = sum(s.mapping.num_views for s in samples)
    pix = sum(s.mapping.num_pixels for s in samples)
    coords = np.concatenate([
        np.concatenate([np.full((len(s.coords), 1), b, np.int32), s.coords], 1)
        for b, s in enumerate(samples)])
    counts, cur, stride = [len(coords)], coords, 1
    for _ in range(4):
        cur, _ = voxel_mod.downsample_coords(cur, stride * 2)
        stride *= 2
        counts.append(len(cur))

    def cap(x, m=64):
        return int(-(-int(x * 1.2) // m) * m)

    return bucket_cls(
        level_caps=[cap(c) for c in counts], num_batches=len(samples),
        view_cap=cap(views), pix_cap=cap(pix), image_ladder=LADDER,
        ladder_image_caps=[2, 2, 2, 2] if families else [0, 1, 2, 2],
        ladder_pix_caps=[cap(pix) if families else 64, cap(pix), cap(pix),
                         cap(pix)])


@functools.lru_cache(maxsize=None)
def jax_ladder_batch():
    """The JAX package's collated crop-ladder batch of
    :func:`jax_ladder_samples` with mappings at levels 0 and 1: ``(numpy
    batch without meta, bucket, samples)``.  Its views spread over three
    buckets and one bucket holds no image."""
    from deepviewagg_tpu.data.collate import Bucket, collate
    from deepviewagg_tpu.ops import voxel

    samples = list(jax_ladder_samples())
    bucket = ladder_bucket(samples, Bucket, voxel)
    batch = collate(samples, bucket, branch_levels=[0, 1])
    return ({k: v for k, v in batch.items() if k != "meta"}, bucket, samples)


def to_torch_samples(samples, **replace):
    """The port's ``Sample``s (and mappings) of JAX-package samples."""
    import dataclasses

    from deepviewagg_tpu_torch.data.collate import Sample
    from deepviewagg_tpu_torch.data.mapping import MultiViewMapping

    return [
        Sample(**{**{f.name: getattr(s, f.name)
                     for f in dataclasses.fields(s) if f.name != "mapping"},
                  **replace},
               mapping=MultiViewMapping(**{
                   f.name: getattr(s.mapping, f.name)
                   for f in dataclasses.fields(s.mapping)}))
        for s in samples]


def fake_s3dis_layout(root, seed: int = 7, density: float = 60.0,
                      panorama=(256, 128), static_rows: int = 16):
    """A miniature 2D-3D-S raw layout under ``root``, as
    ``tests/test_datasets.py::_fake_s3dis`` writes one: ``Area_1`` with one
    room of a synthetic scene split into ``wall_1``, ``chair_1`` and an
    unknown class (``stairs_1``, read as clutter), two posed panoramas of
    ``panorama`` pixels written by the port's ``write_png`` (random colours,
    the bottom ``static_rows`` rows equal in both: a capture rig that the
    non-static mask drops) and ``Area_5`` a symlink to ``Area_1`` (the eval
    fold).  Returns ``root``."""
    import json
    import os

    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(seed)
    scene = synthetic.make_scene(seed=seed, density=density, n_cameras=2,
                                 image_size=(128, 64))
    area = os.path.join(root, "Area_1")
    room = os.path.join(area, "office_1", "Annotations")
    os.makedirs(room)
    n = len(scene.pos)
    for name, sl in [("wall_1.txt", slice(0, n // 2)),
                     ("chair_1.txt", slice(n // 2, 3 * n // 4)),
                     ("stairs_1.txt", slice(3 * n // 4, None))]:
        data = np.concatenate(
            [scene.pos[sl], (scene.rgb[sl] * 255).astype(np.float32)], axis=1)
        np.savetxt(os.path.join(room, name), data, fmt="%.4f")
    pose_dir = os.path.join(area, "data", "pose")
    rgb_dir = os.path.join(area, "data", "rgb")
    os.makedirs(pose_dir)
    os.makedirs(rgb_dir)
    w, h = panorama
    rig = rng.integers(0, 256, (static_rows, w, 3), dtype=np.uint8)
    for i, cam in enumerate(scene.cameras):
        with open(os.path.join(pose_dir, f"camera_{i}_office_1_pose.json"),
                  "w") as f:
            json.dump({
                "camera_location": [float(v) for v in cam.pos],
                "final_camera_rotation": [float(v) for v in cam.opk],
            }, f)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[h - static_rows:] = rig
        write_png(os.path.join(rgb_dir, f"camera_{i}_office_1_rgb.png"), img)
    os.symlink(area, os.path.join(root, "Area_5"))
    return root


# --- cameras -----------------------------------------------------------------

CAMERA_MODELS = ("s3dis_equirectangular", "scannet", "kitti360_perspective",
                 "kitti360_fisheye")
# MEI parameters of KITTI-360's image_02 calibration (xi, k1, k2, gamma1,
# gamma2, u0, v0 as ``tests/test_kitti360_fisheye.py`` writes them), at a
# tenth of the 1400 x 1400 frame
FISHEYE = np.array([2.2, 0.02, -0.01, 132.0, 132.0, 70.0, 70.0], np.float32)


def camera_fields(model: str, seed: int = 0, image_size=(96, 64)) -> dict:
    """``Camera`` fields (host numpy, either package's class takes them) of
    one camera of ``model`` inside ``data/synthetic.py``'s room: the
    scene's own equirectangular or ScanNet camera, and for KITTI-360 the
    ScanNet camera's cam->world pose with its pinhole intrinsics or the
    MEI fisheye parameters above (a 140 x 140 frame)."""
    from deepviewagg_tpu_torch.data import synthetic

    base = "s3dis_equirectangular" if model == "s3dis_equirectangular" \
        else "scannet"
    scene = synthetic.make_scene(seed=seed, density=5.0, n_cameras=1,
                                 image_size=image_size, camera_model=base)
    cam = scene.cameras[0]
    fields = {f.name: getattr(cam, f.name)
              for f in dataclasses.fields(cam)}
    fields["model"] = model
    if model == "kitti360_fisheye":
        fields.update(size=(140, 140), intrinsic=None, fisheye=FISHEYE)
    return fields


def camera_scene(seed: int = 0, density: float = 60.0):
    """The points of one ``data/synthetic.py`` room (float32)."""
    from deepviewagg_tpu_torch.data import synthetic

    return synthetic.make_scene(seed=seed, density=density,
                                n_cameras=1).pos.astype(np.float32)


# --- ScanNet -----------------------------------------------------------------

SCANNET_SCANS = ("scene0000_00", "scene0001_00", "scene0002_00")


def _add_faces(path: str, n_vertices: int, seed: int) -> None:
    """Append a triangle list to a binary PLY, as the real
    ``_vh_clean_2.ply`` meshes carry (the readers skip it)."""
    rng = np.random.default_rng(seed)
    data = open(path, "rb").read()
    head, body = data.split(b"end_header\n", 1)
    n_faces = max(1, n_vertices // 2)
    faces = np.empty(n_faces, np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    faces["n"] = 3
    faces["v"] = rng.integers(0, n_vertices, (n_faces, 3))
    with open(path, "wb") as f:
        f.write(head + f"element face {n_faces}\nproperty list uchar int "
                "vertex_indices\nend_header\n".encode())
        f.write(body + faces.tobytes())


def scannet_frame(pos, rgb, camera, seed: int) -> np.ndarray:
    """``uint8 [H, W, 3]`` photo-like frame at the camera's size: smooth
    shading, the colour of the nearest point at each projected pixel."""
    import torch

    from deepviewagg_tpu_torch.core.cameras import project

    w, h = camera.size
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(x / (25.0 + seed)) * 40 + 120,
                    np.cos(y / 19.0) * 35 + 110,
                    (x + y) * (60.0 / (w + h)) + 90], axis=-1)
    px, py, dist, valid = (t.numpy() for t in project(
        torch.from_numpy(np.asarray(pos, np.float32)), camera))
    order = np.argsort(-dist[valid], kind="stable")   # the nearest last
    xi = px[valid].astype(np.int64)[order]
    yi = py[valid].astype(np.int64)[order]
    img[yi, xi] = rgb[valid][order] * 255
    return np.clip(img, 0, 255).astype(np.uint8)


def fake_scannet_layout(root, scans=SCANNET_SCANS, splits=True,
                        seed: int = 9, density: float = 60.0,
                        frames: int = 3, frame_step: int = 2,
                        native=(128, 96)):
    """A miniature ScanNet v2 layout under ``root``, as
    ``tests/test_datasets.py::test_scannet_pipeline`` writes one: per scan a
    synthetic room (``camera_model="scannet"``) as ``<scan>_vh_clean_2.ply``
    (the first with a face list) and ``.labels.ply`` (NYU40: wall 1, floor
    2, an out-of-benchmark 13 and 0, read as -1), a pose file for every
    frame but colour (the port's ``write_jpeg``, ``native`` pixels) only at
    multiples of ``frame_step``, one more pose that is not finite, and
    ``intrinsic_color.txt`` at the native size; with ``splits`` the last
    scan is listed in ``scannetv2_val.txt``, the others in
    ``scannetv2_train.txt``.  Returns ``root``."""
    import os

    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.utils.image_io import write_jpeg
    from deepviewagg_tpu_torch.utils.ply import write_ply

    for s, scan in enumerate(scans):
        scene = synthetic.make_scene(seed=seed + s, density=density,
                                     n_cameras=frames, image_size=native,
                                     camera_model="scannet")
        d = os.path.join(root, "scans", scan)
        for sub in ("pose", "color", "intrinsic"):
            os.makedirs(os.path.join(d, sub))
        rgb = (scene.rgb * 255).astype(np.uint8)
        ply = os.path.join(d, f"{scan}_vh_clean_2.ply")
        write_ply(ply, {"x": scene.pos[:, 0], "y": scene.pos[:, 1],
                        "z": scene.pos[:, 2], "red": rgb[:, 0],
                        "green": rgb[:, 1], "blue": rgb[:, 2]})
        if s == 0:
            _add_faces(ply, len(scene.pos), seed)
        nyu = np.array([2, 1, 13, 0], np.uint16)[scene.labels % 4]
        write_ply(os.path.join(d, f"{scan}_vh_clean_2.labels.ply"), {
            "x": scene.pos[:, 0], "y": scene.pos[:, 1], "z": scene.pos[:, 2],
            "label": nyu})
        for i, cam in enumerate(scene.cameras):
            for j in range(frame_step):
                # the frames in between: poses without colour
                k = i * frame_step + j
                np.savetxt(os.path.join(d, "pose", f"{k}.txt"), cam.extrinsic)
            write_jpeg(os.path.join(d, "color", f"{i * frame_step}.jpg"),
                       scannet_frame(scene.pos, scene.rgb, cam, seed + i))
        bad = frames * frame_step
        np.savetxt(os.path.join(d, "pose", f"{bad}.txt"),
                   np.full((4, 4), np.inf, np.float32))
        write_jpeg(os.path.join(d, "color", f"{bad}.jpg"),
                   np.zeros((native[1], native[0], 3), np.uint8))
        np.savetxt(os.path.join(d, "intrinsic", "intrinsic_color.txt"),
                   np.asarray(scene.cameras[0].intrinsic, np.float32))
    if splits:
        with open(os.path.join(root, "scannetv2_train.txt"), "w") as f:
            f.write("".join(f"{s}\n" for s in scans[:-1]))
        with open(os.path.join(root, "scannetv2_val.txt"), "w") as f:
            f.write(f"{scans[-1]}\n")
    return root


# --- KITTI-360 ---------------------------------------------------------------

KITTI360_SEQ = "2013_05_28_drive_0000_sync"
# window -> split; the windows overlap in frames, as the release's do
KITTI360_WINDOWS = {"0000000000_0000000040": "train",
                    "0000000030_0000000070": "train",
                    "0000000060_0000000100": "val"}
# KITTI-360 semantic ids of the street's parts (kitti360scripts labels)
KITTI360_IDS = {"road": 7, "sidewalk": 8, "building": 11, "car": 26,
                "vegetation": 21, "unlabelled": 0}
# MEI calibration of KITTI-360's image_02.yaml, as the release writes it
# (a ``%YAML:1.0`` directive, a document start, exponent floats, p1 / p2)
KITTI360_FISHEYE_YAML = (
    "%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_02\n"
    "image_width: 1400\nimage_height: 1400\nmirror_parameters:\n"
    "   xi: 2.2134047507854890e+00\ndistortion_parameters:\n"
    "   k1: 1.6798235660113681e-02\n   k2: 1.6548773243373522e+00\n"
    "   p1: 4.2223943394772046e-04\n   p2: 4.2462134260997584e-04\n"
    "projection_parameters:\n   gamma1: 1.3363220825849971e+03\n"
    "   gamma2: 1.3357883350012958e+03\n   u0: 7.1694323510126321e+02\n"
    "   v0: 7.0576498308221585e+02\n")
# the same parameters as ``tests/test_kitti360_fisheye.py`` writes them
KITTI360_FISHEYE_FIXTURE_YAML = (
    "%YAML:1.0\nmirror_parameters:\n   xi: 2.2\n"
    "distortion_parameters:\n   k1: 0.02\n   k2: -0.01\n"
    "projection_parameters:\n   gamma1: 1320.0\n   gamma2: 1320.0\n"
    "   u0: 700.0\n   v0: 700.0\n")
# perspective.txt in the release's form (its calib_time line included)
KITTI360_PERSPECTIVE = (
    "calib_time: 09-Jan-2012 14:00:15\n"
    "S_00: 1.392000e+03 5.120000e+02\n"
    "K_00: 7.880000e+02 0.000000e+00 6.870000e+02 0.000000e+00 7.860000e+02"
    " 3.170000e+02 0.000000e+00 0.000000e+00 1.000000e+00\n"
    "S_rect_00: 1.408000e+03 3.760000e+02\n"
    "R_rect_00: 9.999974e-01 -7.253732e-04 -2.195405e-03 7.102433e-04 "
    "9.999894e-01 -4.462649e-03 2.198609e-03 4.461186e-03 9.999876e-01\n"
    "P_rect_00: 5.525500e+02 0.000000e+00 6.820500e+02 0.000000e+00 "
    "0.000000e+00 5.525500e+02 2.387700e+02 0.000000e+00 0.000000e+00 "
    "0.000000e+00 1.000000e+00 0.000000e+00\n"
    "P_rect_01: 5.525500e+02 0.000000e+00 6.820500e+02 -3.268276e+02 "
    "0.000000e+00 5.525500e+02 2.387700e+02 0.000000e+00 0.000000e+00 "
    "0.000000e+00 1.000000e+00 0.000000e+00\n")
# camera axes in the vehicle (= world) frame: cam0 looks along +x, cam2
# (left fisheye) along +y, cam3 (right fisheye) along -y; image y is down
KITTI360_CAM_AXES = {
    0: np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]),
    2: np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]),
    3: np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]]),
}


def street_scene(x0: float, x1: float, density: float, seed: int,
                 half_width: float = 5.5, height: float = 5.0):
    """A straight street along x over ``[x0, x1]``: road (|y| < 3.5) and
    sidewalks on the ground, facades at ``y = +-half_width`` up to
    ``height``, one parked car (a box) and one tree crown (a ball) every
    10 m, unlabelled clutter; ``density`` points per m^2 of surface, 2 cm
    of noise on every point (an exact plane leaves PCA's smallest
    eigenvalue to rounding).  Returns ``(pos float32 [N, 3], rgb uint8
    [N, 3], KITTI-360 ids int32 [N])``."""
    rng = np.random.default_rng(seed)
    length = x1 - x0
    parts = []

    def plane(n, lo, hi, sem, colour):
        p = rng.uniform(lo, hi, (n, 3))
        parts.append((p, sem, colour))

    n_ground = int(density * length * 2 * half_width)
    g = rng.uniform((x0, -half_width, 0.0), (x1, half_width, 0.0),
                    (n_ground, 3))
    road = np.abs(g[:, 1]) < 3.5
    parts.append((g[road], KITTI360_IDS["road"], (80, 80, 85)))
    parts.append((g[~road], KITTI360_IDS["sidewalk"], (150, 140, 130)))
    n_facade = int(density * length * height)
    for side in (-1.0, 1.0):
        plane(n_facade, (x0, side * half_width, 0.0),
              (x1, side * half_width, height), KITTI360_IDS["building"],
              (170, 120, 90) if side > 0 else (200, 190, 160))
    for cx in np.arange(x0 + 3.0, x1, 10.0):
        n_car = int(density * 14.0)
        c = rng.uniform((cx, -3.4, 0.0), (cx + 4.0, -1.7, 1.5), (n_car, 3))
        face = rng.integers(0, 3, n_car)       # snap to a box face
        c[face == 0, 1] = -1.7
        c[face == 1, 2] = 1.5
        c[face == 2, 0] = cx
        parts.append((c, KITTI360_IDS["car"], (30, 60, 160)))
        n_tree = int(density * 12.0)
        d = rng.normal(size=(n_tree, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        parts.append((d * 1.0 + (cx + 6.0, 4.3, 3.0),
                      KITTI360_IDS["vegetation"], (40, 140, 50)))
    n_clutter = int(density * length * 0.2)
    plane(n_clutter, (x0, -half_width, 0.0), (x1, half_width, 0.5),
          KITTI360_IDS["unlabelled"], (120, 120, 120))
    pos = np.concatenate([p for p, _, _ in parts])
    pos = (pos + rng.normal(0.0, 0.02, pos.shape)).astype(np.float32)
    sem = np.concatenate([np.full(len(p), s, np.int32) for p, s, _ in parts])
    rgb = np.concatenate([
        np.clip(np.asarray(c, np.float64) + rng.normal(0, 12, (len(p), 3)),
                0, 255) for p, _, c in parts]).astype(np.uint8)
    return pos, rgb, sem


def kitti360_vehicle(frame: int, speed: float = 0.3):
    """The vehicle's 4x4 pose at ``frame``: no rotation, ``speed`` m a frame
    along +x, 1.7 m above the road."""
    pose = np.eye(4)
    pose[:3, 3] = (frame * speed, 0.0, 1.7)
    return pose


def write_kitti360_calibration(root, fisheye_yaml=KITTI360_FISHEYE_YAML,
                               fisheye03_yaml=KITTI360_FISHEYE_FIXTURE_YAML):
    """``calibration/`` of a KITTI-360 layout: ``perspective.txt`` in the
    release's form, ``calib_cam_to_pose.txt`` (cam -> vehicle, the axes of
    ``KITTI360_CAM_AXES``), ``image_02.yaml`` / ``image_03.yaml``."""
    import os

    calib = os.path.join(root, "calibration")
    os.makedirs(calib, exist_ok=True)
    with open(os.path.join(calib, "perspective.txt"), "w") as f:
        f.write(KITTI360_PERSPECTIVE)
    offsets = {0: (1.5, 0.0, 0.0), 2: (0.8, 0.5, 0.1), 3: (0.8, -0.5, 0.1)}
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        for cam in (0, 1, 2, 3):
            m = np.zeros((3, 4))
            m[:, :3] = KITTI360_CAM_AXES.get(cam, KITTI360_CAM_AXES[0])
            m[:, 3] = offsets.get(cam, (1.5, -0.6, 0.0))
            f.write(f"image_0{cam}: " + " ".join(f"{v:.9f}" for v in m.flat)
                    + "\n")
    with open(os.path.join(calib, "image_02.yaml"), "w") as f:
        f.write(fisheye_yaml)
    with open(os.path.join(calib, "image_03.yaml"), "w") as f:
        f.write(fisheye03_yaml)


def fake_kitti360_layout(root, seed: int = 11, density: float = 6.0,
                         frames=range(0, 101, 5), pinhole=(352, 94),
                         fisheye=(140, 140), static_rows: int = 12):
    """A miniature KITTI-360 release layout under ``root``, on the shape of
    ``tests/test_datasets.py::test_kitti360_pipeline`` and
    ``tests/test_kitti360_fisheye.py``: one sequence, the three overlapping
    windows of ``KITTI360_WINDOWS`` (a ``street_scene`` each, with the
    release's extra PLY fields ``instanceId``, ``isVisible`` and
    ``confidence``) listed in ``data_3d_semantics/train/
    2013_05_28_drive_{train,val}.txt``; ``cam0_to_world.txt`` and
    ``poses.txt`` with a row every 5 frames (the loaders keep multiples of
    their ``frame_step``); ``calibration/`` (``write_kitti360_calibration``:
    image_02.yaml in the release's form, image_03.yaml in the JAX test
    fixture's); a cam0 PNG of ``pinhole`` pixels and cam2 / cam3 PNGs of
    ``fisheye`` pixels at every tenth frame, written by the port's
    ``write_png`` with every row filter type (random colours; the bottom
    ``static_rows`` rows of the fisheyes the same in every frame, as the
    vehicle's body is; no cam3 PNG at frame 50).  Returns ``root``."""
    import os

    from deepviewagg_tpu_torch.utils.image_io import write_png
    from deepviewagg_tpu_torch.utils.ply import write_ply

    rng = np.random.default_rng(seed)
    static = os.path.join(root, "data_3d_semantics", KITTI360_SEQ, "static")
    os.makedirs(static)
    for w, name in enumerate(KITTI360_WINDOWS):
        start, end = (int(v) for v in name.split("_"))
        pos, rgb, sem = street_scene(start * 0.3 - 4.0, end * 0.3 + 12.0,
                                     density, seed + w)
        n = len(pos)
        write_ply(os.path.join(static, f"{name}.ply"), {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
            "semantic": sem,
            "instanceId": (sem * 1000 + rng.integers(0, 5, n)).astype(
                np.int32),
            "isVisible": rng.integers(0, 2, n).astype(np.uint8),
            "confidence": rng.uniform(0, 1, n).astype(np.float32)})
    lists = os.path.join(root, "data_3d_semantics", "train")
    os.makedirs(lists)
    for split in ("train", "val"):
        with open(os.path.join(lists, f"2013_05_28_drive_{split}.txt"),
                  "w") as f:
            f.writelines(f"data_3d_semantics/{KITTI360_SEQ}/static/{n}.ply\n"
                         for n, sp in KITTI360_WINDOWS.items() if sp == split)
    poses_dir = os.path.join(root, "data_poses", KITTI360_SEQ)
    os.makedirs(poses_dir)
    cam_rows, imu_rows = [], []
    for frame in frames:
        vehicle = kitti360_vehicle(frame)
        cam0 = vehicle.copy()
        cam0[:3, :3] = KITTI360_CAM_AXES[0]
        cam0[:3, 3] += (1.5, 0.0, 0.0)
        cam_rows.append([frame] + list(cam0.flatten()))
        imu_rows.append([frame] + list(vehicle[:3].flatten()))
    np.savetxt(os.path.join(poses_dir, "cam0_to_world.txt"),
               np.array(cam_rows))
    np.savetxt(os.path.join(poses_dir, "poses.txt"), np.array(imu_rows))
    write_kitti360_calibration(root)
    body = rng.integers(0, 256, (static_rows, fisheye[0], 3), dtype=np.uint8)
    for cam, sub, (w, h) in ((0, "data_rect", pinhole),
                             (2, "data_rgb", fisheye),
                             (3, "data_rgb", fisheye)):
        d = os.path.join(root, "data_2d_raw", KITTI360_SEQ, f"image_0{cam}",
                         sub)
        os.makedirs(d)
        for frame in frames:
            if frame % 10 or (cam == 3 and frame == 50):
                continue
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            if cam:
                img[h - static_rows:] = body
            write_png(os.path.join(d, f"{frame:010d}.png"), img,
                      filters=np.arange(h) % 5)
    return root


# --- pretrained ResNet-18 checkpoints ---------------------------------------

def resnet18_state_dict(deep_stem: bool = False, ppm_channels=None,
                        seed: int = 0):
    """A random-weight ResNet-18 ``state_dict`` in a published key layout,
    with non-trivial BatchNorm scales, biases and running statistics:
    torchvision's (``conv1`` / ``bn1``, ``layer{i}.{j}.conv{k}`` /
    ``bn{k}``, ``downsample.0/1``) built by
    ``test_torch_convert.TorchResNet18``; with ``deep_stem`` the MIT-semseg
    encoder's (``conv1..3`` / ``bn1..3`` of 64, 64, 128 channels, layer1's
    first block projecting 128 -> 64), under ``encoder.``; with
    ``ppm_channels`` also the MIT-semseg PPM decoder's keys under
    ``decoder.`` (``ppm.{i}.1/2`` for bins 1, 2, 3, 6, ``conv_last.0/1``,
    and the classifier ``conv_last.4`` that no tower takes)."""
    import torch.nn as tnn
    from test_torch_convert import TorchBasicBlock, TorchResNet18

    torch.manual_seed(seed)
    net = TorchResNet18()
    if deep_stem:
        net.conv1 = tnn.Conv2d(3, 64, 3, 2, 1, bias=False)
        net.conv2 = tnn.Conv2d(64, 64, 3, 1, 1, bias=False)
        net.bn2 = tnn.BatchNorm2d(64)
        net.conv3 = tnn.Conv2d(64, 128, 3, 1, 1, bias=False)
        net.bn3 = tnn.BatchNorm2d(128)
        net.layer1[0] = TorchBasicBlock(128, 64)
    parts = {("encoder." if deep_stem else ""): net}
    if ppm_channels:
        dec = tnn.Module()
        dec.ppm = tnn.ModuleList([tnn.Sequential(
            tnn.AdaptiveAvgPool2d(b), tnn.Conv2d(512, ppm_channels, 1,
                                                 bias=False),
            tnn.BatchNorm2d(ppm_channels), tnn.ReLU())
            for b in (1, 2, 3, 6)])
        dec.conv_last = tnn.Sequential(
            tnn.Conv2d(512 + 4 * ppm_channels, ppm_channels, 3, padding=1,
                       bias=False),
            tnn.BatchNorm2d(ppm_channels), tnn.ReLU(), tnn.Dropout2d(0.1),
            tnn.Conv2d(ppm_channels, 150, 1))
        parts["decoder."] = dec
    sd = {}
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for prefix, mod in parts.items():
            for m in mod.modules():
                if isinstance(m, tnn.BatchNorm2d):
                    m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                                   + 0.5)
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.2)
                    m.running_mean.copy_(torch.randn(
                        m.running_mean.shape, generator=gen) * 0.3)
                    m.running_var.copy_(torch.rand(
                        m.running_var.shape, generator=gen) * 1.5 + 0.5)
            sd.update({prefix + k: v.clone()
                       for k, v in mod.state_dict().items()})
    return sd


def write_resnet18_checkpoint(path, deep_stem: bool = False,
                              ppm_channels=None, seed: int = 0,
                              wrap: bool = False):
    """:func:`resnet18_state_dict` saved with ``torch.save`` at ``path``
    (``wrap``: as ``{"state_dict": ...}`` with ``module.`` keys, a
    DataParallel save); returns ``str(path)``."""
    sd = resnet18_state_dict(deep_stem, ppm_channels, seed)
    if wrap:
        sd = {"state_dict": {"module." + k: v for k, v in sd.items()}}
    torch.save(sd, str(path))
    return str(path)
