"""Shared helpers of the ``test_torch_port_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port on the CPU."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.data.collate import batch_to_torch

TINY_SPEC = dict(backbone="Res16UNetTest", tower="resnet18_l1", num_groups=2)
TINY_BATCH = dict(n_samples=1, density=25.0, image_size=(64, 32), n_cameras=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Tier-1 runs several workers at once: keep torch to two threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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
    """Largest absolute difference over the largest magnitude of ``b``."""
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
