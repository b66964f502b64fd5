"""The image / mapping transforms of the PyTorch port against the JAX
package: the S3DIS recipe's ``center_roll``, ``random_horizontal_flip``,
``jitter_mapping_features``, ``color_jitter``, ``gaussian_blur`` and their
helpers ``_to_unit_float`` / ``_grayscale``; then the rest of the module:
``crop_images``, ``non_static_mask`` / ``mask_mapping_pixels`` (which the
S3DIS preprocess applies), ``drop_images_outside_bbox``, ``pick_k_images``,
``grid_sample_images``, ``add_pixel_height_feature`` /
``add_pixel_width_feature`` and ``pick_mappings_by_features``.

All are host numpy copied from the JAX package: from the same inputs and the
same ``np.random.Generator`` seed they must give byte-identical arrays and
leave the generator in the same state (the draws are made in the same
order)."""

import dataclasses

import numpy as np
import pytest

from deepviewagg_tpu.data import mapping as jmapping
from deepviewagg_tpu.data import transforms2d as jt2
from deepviewagg_tpu_torch.data import transforms2d as tt2
from deepviewagg_tpu_torch.data.datasets import base as tbase
from deepviewagg_tpu_torch.data.datasets import synthetic_ds as tsds
from torch_port_util import _torch_threads, assert_identical  # noqa: F401


@pytest.fixture(scope="module")
def area(tmp_path_factory):
    """One synthetic room with three 64 x 32 float32 images in [0, 1] (raw,
    not normalised) and its mapping (built by the port on the CPU; only the
    transforms are compared)."""
    root = tmp_path_factory.mktemp("t2d")
    path, = tsds.build_synthetic_cache(str(root), n_areas=1, density=30.0,
                                       n_cameras=3, image_size=(64, 32),
                                       device="cpu")
    cloud = tbase.load_area(path)
    images = cloud["images"]
    assert images.dtype == np.float32 and len(images) == 3
    assert 0.0 <= images.min() and images.max() <= 1.0
    return cloud


def _clouds(area, images=None, **mapping_changes):
    """The same cloud for each package (its own mapping class)."""
    m = dataclasses.replace(area["mapping"], **mapping_changes)
    jm = jmapping.MultiViewMapping(**{f.name: getattr(m, f.name)
                                      for f in dataclasses.fields(m)})
    imgs = np.array(area["images"] if images is None else images)
    return {"mapping": jm, "images": imgs.copy()}, \
        {"mapping": m, "images": imgs.copy()}


def _rngs(seed=3):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_state(ja, ta):
    assert ja.bit_generator.state == ta.bit_generator.state


def test_center_roll_identical(area):
    """Mapped pixels kept in the left quarter of each panorama (a whole
    room's span every column, so that no roll beats the zero one)."""
    m = area["mapping"]
    w = area["images"].shape[1]
    jc, tc = _clouds(area, pix_valid=m.pix_valid & (m.pix_x < w // 4))
    ref, got = jt2.center_roll(jc), tt2.center_roll(tc)
    assert_identical(ref, got)
    # at least one image was rolled, with its mapping
    assert not np.array_equal(got["images"], tc["images"])
    assert not np.array_equal(got["mapping"].pix_x, tc["mapping"].pix_x)


def test_center_roll_no_shift(area):
    """Mapped pixels already centred: the zero roll wins, nothing moves."""
    m = area["mapping"]
    w = area["images"].shape[1]
    jc, tc = _clouds(area, pix_x=np.full_like(m.pix_x, w // 2))
    ref, got = jt2.center_roll(jc), tt2.center_roll(tc)
    assert_identical(ref, got)
    assert_identical(got["mapping"], tc["mapping"])
    assert np.array_equal(got["images"], tc["images"])


def test_center_roll_no_pixel(area):
    """A mapping without a valid pixel returns the cloud itself."""
    jc, tc = _clouds(area,
                     pix_valid=np.zeros_like(area["mapping"].pix_valid))
    assert jt2.center_roll(jc) is jc
    assert tt2.center_roll(tc) is tc


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_random_horizontal_flip_identical(area, p):
    jr, tr = _rngs()
    jc, tc = _clouds(area)
    flipped = 0
    for _ in range(4):
        ref = jt2.random_horizontal_flip(jc, jr, p=p)
        got = tt2.random_horizontal_flip(tc, tr, p=p)
        assert_identical(ref, got)
        flipped += got is not tc
    _same_state(jr, tr)
    assert flipped == {0.0: 0, 1.0: 4}.get(p, flipped)
    assert 0 < flipped < 4 or p != 0.5


@pytest.mark.parametrize("sigma,clip", [(0.02, 0.03), (0.05, 0.01)])
def test_jitter_mapping_features_identical(area, sigma, clip):
    jr, tr = _rngs()
    jc, tc = _clouds(area)
    ref = jt2.jitter_mapping_features(jc, sigma=sigma, clip=clip, rng=jr)
    got = tt2.jitter_mapping_features(tc, sigma=sigma, clip=clip, rng=tr)
    assert_identical(ref, got)
    _same_state(jr, tr)
    delta = got["mapping"].view_feats - tc["mapping"].view_feats
    assert 0 < np.abs(delta).max() <= clip + 1e-6


def _image_inputs(area):
    unit = np.asarray(area["images"])
    u8 = np.round(unit * 255.0).astype(np.uint8)
    return {"uint8": u8, "unit_float": unit,
            "byte_float": u8.astype(np.float32)}


@pytest.mark.parametrize("kind", ["uint8", "unit_float", "byte_float"])
def test_to_unit_float_and_grayscale_identical(area, kind):
    images = _image_inputs(area)[kind]
    ref, got = jt2._to_unit_float(images), tt2._to_unit_float(images)
    assert_identical(ref, got)
    assert got.dtype == np.float32 and 0.0 <= got.min() and got.max() <= 1.0
    assert_identical(jt2._grayscale(ref), tt2._grayscale(got))


@pytest.mark.parametrize("strengths", [(0.6, 0.6, 0.7), (0.0, 0.4, 0.0),
                                       (0.3, 0.0, 0.9)])
def test_color_jitter_identical(area, strengths):
    jr, tr = _rngs()
    for images in _image_inputs(area).values():
        ref = jt2.color_jitter(images, jr, *strengths)
        got = tt2.color_jitter(images, tr, *strengths)
        assert_identical(ref, got)
        assert not np.array_equal(got, tt2._to_unit_float(images))
    _same_state(jr, tr)


@pytest.mark.parametrize("kernel_size", [9, 5])
def test_gaussian_blur_identical(area, kernel_size):
    jr, tr = _rngs()
    for images in _image_inputs(area).values():
        ref = jt2.gaussian_blur(images, jr, kernel_size=kernel_size)
        got = tt2.gaussian_blur(images, tr, kernel_size=kernel_size)
        assert_identical(ref, got)
    _same_state(jr, tr)


@pytest.mark.parametrize("fn", ["_to_unit_float", "color_jitter",
                                "gaussian_blur"])
def test_radiometric_refuses_normalized_images(area, fn):
    """ImageNet-normalised stacks (negative values) raise in both."""
    normalized = tt2.normalize_images(area["images"])
    assert normalized.min() < -0.01
    for mod in (jt2, tt2):
        args = () if fn == "_to_unit_float" else (np.random.default_rng(0),)
        with pytest.raises(ValueError, match="already-normalized"):
            getattr(mod, fn)(normalized, *args)


# --- the rest of the module: crops, static masks, image-set reductions,
# pixel-coordinate channels, mapping-feature picks --------------------------

def _full_clouds(area, images=None, cam_pos=None):
    """``_clouds`` with the points and the cameras' positions."""
    jc, tc = _clouds(area, images=images)
    for c in (jc, tc):
        c["pos"] = np.array(area["pos"])
        if cam_pos is not None:
            c["cam_pos"] = np.array(cam_pos)
    return jc, tc


@pytest.mark.parametrize("crop", [(32, 16), (48, 20), (64, 32), (17, 9)])
def test_crop_images_identical(area, crop):
    """A crop per image around its mapped pixels: images, shifted pixels
    and the pixels that fall outside (pads, one kept per view); the full
    size returns the cloud itself."""
    for images in _image_inputs(area).values():
        jc, tc = _clouds(area, images=images)
        ref, got = jt2.crop_images(jc, crop), tt2.crop_images(tc, crop)
        assert_identical(ref, got)
        if crop == (64, 32):
            assert got is tc
        else:
            assert got["images"].shape[1:3] == crop
            got["mapping"].check()
            assert got["mapping"].pix_valid.sum() \
                < tc["mapping"].pix_valid.sum()


def _static_stack(area):
    """uint8 images equal to each other on a band of rows (a capture rig)."""
    u8 = _image_inputs(area)["uint8"].copy()
    u8[:, :, 20:] = u8[0, :, 20:]
    return u8


@pytest.mark.parametrize("n_sample", [1, 2, 3, 5])
@pytest.mark.parametrize("seeded", [False, True])
def test_non_static_mask_identical(area, n_sample, seeded):
    images = _static_stack(area)
    jr, tr = _rngs(4) if seeded else (None, None)
    ref = jt2.non_static_mask(images, n_sample=n_sample, rng=jr)
    got = tt2.non_static_mask(images, n_sample=n_sample, rng=tr)
    assert_identical(ref, got)
    if seeded:
        _same_state(jr, tr)
    assert got.shape == images.shape[1:3] and got.dtype == bool
    if n_sample > 1:
        assert not got[:, 20:].any() and got[:, :20].mean() > 0.9
    else:
        assert got.all()


def test_mask_mapping_pixels_identical(area):
    mask = tt2.non_static_mask(_static_stack(area))
    jc, tc = _clouds(area)
    ref = jt2.mask_mapping_pixels(jc, mask)
    got = tt2.mask_mapping_pixels(tc, mask)
    assert_identical(ref, got)
    m, before = got["mapping"], tc["mapping"]
    m.check()
    assert 0 < m.pix_valid.sum() < before.pix_valid.sum()
    assert not (m.pix_y[m.pix_valid] >= 20).any()
    # a mask that keeps everything changes nothing
    keep_all = np.ones_like(mask)
    assert_identical(tt2.mask_mapping_pixels(tc, keep_all)["mapping"],
                     jt2.mask_mapping_pixels(jc, keep_all)["mapping"])


def _cam_pos(area):
    """Camera positions: two inside the cloud's box, one 5 m above it."""
    lo, hi = area["pos"].min(axis=0), area["pos"].max(axis=0)
    mid = (lo + hi) / 2
    return np.stack([mid, mid + 0.1, mid + np.array([0.0, 0.0, 5.0])]
                    ).astype(np.float32)


@pytest.mark.parametrize("margin,ignore_z", [(0.0, False), (0.0, True),
                                             (20.0, False)])
def test_drop_images_outside_bbox_identical(area, margin, ignore_z):
    jc, tc = _full_clouds(area, cam_pos=_cam_pos(area))
    ref = jt2.drop_images_outside_bbox(jc, margin=margin, ignore_z=ignore_z)
    got = tt2.drop_images_outside_bbox(tc, margin=margin, ignore_z=ignore_z)
    assert_identical(ref, got)
    kept = len(got["images"])
    assert kept == (3 if ignore_z or margin else 2)
    assert got["mapping"].num_images == kept


@pytest.mark.parametrize("k,random", [(1, False), (2, False), (2, True),
                                      (5, True)])
def test_pick_k_images_identical(area, k, random):
    jc, tc = _full_clouds(area, cam_pos=_cam_pos(area))
    for seeded in (False, True):
        jr, tr = _rngs(6) if seeded else (None, None)
        ref = jt2.pick_k_images(jc, k, random=random, rng=jr)
        got = tt2.pick_k_images(tc, k, random=random, rng=tr)
        assert_identical(ref, got)
        if seeded:
            _same_state(jr, tr)
        assert len(got["images"]) == (min(k, 3) if random else len(
            range(0, 3, k)))


@pytest.mark.parametrize("size", [0.05, 0.5, 100.0])
def test_grid_sample_images_identical(area, size):
    cam_pos = _cam_pos(area)
    cam_pos[1] = cam_pos[0]          # two images from one viewpoint
    jc, tc = _full_clouds(area, cam_pos=cam_pos)
    ref, got = jt2.grid_sample_images(jc, size), \
        tt2.grid_sample_images(tc, size)
    assert_identical(ref, got)
    cells = {tuple(c) for c in np.floor(cam_pos / size).astype(int)}
    assert len(got["images"]) == len(cells) == (1 if size == 100.0 else 2)
    # the last image of a cell stays
    last = 2 if size == 100.0 else 1
    assert np.array_equal(got["images"][0], tc["images"][last])


@pytest.mark.parametrize("fn", ["add_pixel_height_feature",
                                "add_pixel_width_feature"])
def test_pixel_coordinate_channels_identical(area, fn):
    for images in _image_inputs(area).values():
        ref, got = getattr(jt2, fn)(images), getattr(tt2, fn)(images)
        assert_identical(ref, got)
        assert got.shape == images.shape[:3] + (4,)
        assert got[..., 3].min() == 0.0 and got[..., 3].max() == 1.0


@pytest.mark.parametrize("feat,lower,upper", [
    (0, 0.5, None), (5, None, 0.5), ([0, 4], [None, 0.25], [0.75, None]),
    ((1, 2), (0.1, 0.1), (0.9, 0.9)), (None, None, None)])
def test_pick_mappings_by_features_identical(area, feat, lower, upper):
    """Bounds at quantiles of each feature over the valid views."""
    jc, tc = _clouds(area)
    m = tc["mapping"]

    def at(q, i):
        return None if q is None else float(
            np.quantile(m.view_feats[m.view_valid, i], q))

    if feat is not None:
        seq = isinstance(feat, (list, tuple))
        feats = list(feat) if seq else [feat]
        lo = list(lower) if seq else [lower]
        up = list(upper) if seq else [upper]
        lower = [at(q, i) for q, i in zip(lo, feats)]
        upper = [at(q, i) for q, i in zip(up, feats)]
        if not seq:
            lower, upper = lower[0], upper[0]
    ref = jt2.pick_mappings_by_features(jc, feat, lower, upper)
    got = tt2.pick_mappings_by_features(tc, feat, lower, upper)
    assert_identical(ref, got)
    got["mapping"].check()
    kept, before = got["mapping"].view_valid.sum(), \
        tc["mapping"].view_valid.sum()
    assert kept <= before and (feat is None) == (kept == before)
