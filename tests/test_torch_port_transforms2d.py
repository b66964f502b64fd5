"""The S3DIS recipe's image / mapping transforms of the PyTorch port against
the JAX package: ``center_roll``, ``random_horizontal_flip``,
``jitter_mapping_features``, ``color_jitter``, ``gaussian_blur`` and their
helpers ``_to_unit_float`` / ``_grayscale``.

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
