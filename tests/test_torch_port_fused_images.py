"""The native colour jitter and normalisation pass (``native/images.py``)
against the numpy chain ``normalize_images(color_jitter(...))`` of
``data/transforms2d.py``: the same bits and the same generator state."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from deepviewagg_tpu_torch.data import transforms2d as tt2
from deepviewagg_tpu_torch.native import images as nimages

# the three strength sets of test_color_jitter_identical, and None for
# normalising alone (eval); (0.0, 0.4, 0.0) and (0.3, 0.0, 0.9) leave
# zero-strength ops out of the permutation
STRENGTHS = [(0.6, 0.6, 0.7), (0.0, 0.4, 0.0), (0.3, 0.0, 0.9), None]
# default_rng(seed).permutation(3) gives each of the six op orders once
SEEDS = [0, 1, 3, 5, 7, 11]


def _stack(kind: str, dtype: str) -> np.ndarray:
    """Sizes past the pass's threading threshold (65,536 pixels), with
    chunks that cross images; uint8, or float in [0, 1] ("unit") or in
    [0, 255] ("byte", divided by 255 as uint8 is)."""
    rng = np.random.default_rng(17)
    shape = (1, 512, 256, 3) if kind == "one" else (4, 300, 200, 3)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "edges":       # the clip's edges: all 0, all 255, dark
        u8[0], u8[1] = 0, 255
        u8[2] //= 8
    if dtype == "uint8":
        return u8
    out = u8.astype(np.float32)
    if dtype == "unit":
        out /= 255.0
        if kind == "edges":   # a float cache a little outside [0, 1]
            out[3, :, :100] = 1.3
            out[3, :, 100:] = -0.005
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    assert a.dtype == np.float32
    return a.view(np.uint32)


def test_seeds_cover_every_op_order():
    orders = {tuple(np.random.default_rng(s).permutation(3)) for s in SEEDS}
    assert orders == set(itertools.permutations(range(3)))


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("dtype", ["uint8", "unit", "byte"])
@pytest.mark.parametrize("kind", ["one", "four", "edges"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strengths", STRENGTHS)
def test_fused_pass_matches_the_numpy_chain(strengths, seed, kind, dtype,
                                            threads):
    images = _stack(kind, dtype)
    ref_rng = np.random.default_rng(seed)
    rng = np.random.default_rng(seed)
    if strengths is None:
        ref = tt2.normalize_images(images)
        got = nimages.jitter_normalize(images, threads=threads)
    else:
        ref = tt2.normalize_images(tt2.color_jitter(images, ref_rng,
                                                    *strengths))
        draws = tt2.draw_color_jitter(rng, len(images), *strengths)
        assert len(draws) == sum(s > 0 for s in strengths)
        got = nimages.jitter_normalize(images, draws, threads=threads)
    assert got.shape == ref.shape == images.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert rng.bit_generator.state == ref_rng.bit_generator.state


@pytest.mark.parametrize("dtype", ["uint8", "unit"])
def test_no_draws_still_clip(dtype):
    """Jitter with every strength 0 draws nothing but clips (out-of-range
    float caches show it); normalising alone does not."""
    images = _stack("edges", dtype)
    draws = tt2.draw_color_jitter(np.random.default_rng(0), 4, 0.0, 0.0, 0.0)
    assert draws == []
    clipped = nimages.jitter_normalize(images, draws)
    np.testing.assert_array_equal(_bits(clipped), _bits(tt2.normalize_images(
        tt2.color_jitter(images, np.random.default_rng(0), 0.0, 0.0, 0.0))))
    plain = nimages.jitter_normalize(images)
    np.testing.assert_array_equal(_bits(plain),
                                  _bits(tt2.normalize_images(images)))
    assert np.array_equal(clipped, plain) is (dtype == "uint8")


def test_draws_then_apply_is_color_jitter():
    images = _stack("four", "uint8")
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    ref = tt2.color_jitter(images, a)
    got = tt2.apply_color_jitter(images, tt2.draw_color_jitter(
        b, len(images)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert a.bit_generator.state == b.bit_generator.state


def test_fused_pass_takes_a_strided_float64_or_empty_stack():
    images = _stack("four", "uint8")
    draws = tt2.draw_color_jitter(np.random.default_rng(2), 4)
    for stack in (images[:, ::-1], images.astype(np.float64) / 255.0):
        np.testing.assert_array_equal(
            _bits(nimages.jitter_normalize(stack, draws)),
            _bits(tt2.normalize_images(tt2.apply_color_jitter(stack, draws))))
    empty = images[:0]
    out = nimages.jitter_normalize(
        empty, tt2.draw_color_jitter(np.random.default_rng(2), 0))
    assert out.shape == empty.shape and out.dtype == np.float32


@pytest.mark.parametrize("bad", [np.zeros((2, 8, 8, 3), np.int16),
                                 np.zeros((8, 8, 3), np.uint8),
                                 np.zeros((2, 8, 8, 4), np.float32)])
def test_fused_pass_refuses_other_stacks(bad):
    assert not nimages.takes(bad)
    with pytest.raises(ValueError, match="uint8 or float"):
        nimages.jitter_normalize(bad)


def test_fused_pass_refuses_to_jitter_normalized_images():
    """As ``color_jitter`` refuses; normalising alone takes them."""
    normalized = tt2.normalize_images(_stack("four", "uint8"))
    draws = tt2.draw_color_jitter(np.random.default_rng(0), 4)
    with pytest.raises(ValueError, match="already-normalized"):
        nimages.jitter_normalize(normalized, draws)
    np.testing.assert_array_equal(
        _bits(nimages.jitter_normalize(normalized)),
        _bits(tt2.normalize_images(normalized)))
