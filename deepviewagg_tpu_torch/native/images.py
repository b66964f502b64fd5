"""A sample's colour jitter and ImageNet normalisation in one native pass.

``images.cpp`` (built and loaded like ``kernelmap.cpp``) takes a raw
``[n, W, H, 3]`` stack, uint8 or float, straight to normalised float32 and
gives the bytes of the numpy chain of ``data/transforms2d.py`` (which stays
as the plain version the tests call): ``normalize_images(apply_color_jitter(
images, draws))``, or ``normalize_images(images)`` without draws.  Contrast's
mean is the one reduction: the first native pass writes the gray plane of
the images as they stand before contrast, numpy takes its mean in its own
summation order, and the second pass does the rest.

``threads``: 0 uses the host's cores (at most 16); the bytes do not depend
on it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["takes", "jitter_normalize"]

_OPS = {"brightness": 0, "contrast": 1, "saturation": 2}
_UINT8, _UNIT_FLOAT, _BYTE_FLOAT = 0, 1, 2          # input kinds
# transforms2d.normalize_images' defaults, as numpy casts them
_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def _lib():
    from ..utils import cuda_build

    return cuda_build.load("images")


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _check(code: int, name: str) -> None:
    if code != 0:
        raise ValueError(f"{name} failed with code {code}")


def takes(images: np.ndarray) -> bool:
    """Whether :func:`jitter_normalize` takes ``images``: a uint8 or float
    ``[n, W, H, 3]`` stack."""
    return (images.ndim == 4 and images.shape[-1] == 3
            and (images.dtype == np.uint8 or images.dtype.kind == "f"))


def jitter_normalize(images: np.ndarray,
                     draws: Optional[Sequence[Tuple[str, np.ndarray]]] = None,
                     threads: int = 0) -> np.ndarray:
    """``float32 [n, W, H, 3]``: ``images`` (see :func:`takes`) in [0, 1]
    (over 255 where uint8, or float with a value above 1.5), through the
    colour jitter ``draws`` (``transforms2d.draw_color_jitter``'s, in their
    order) and the clip to [0, 1], then ImageNet's ``(v - mean) / std``.
    ``draws=None`` normalises alone, with no clip, as ``normalize_images``
    does."""
    img = np.asarray(images)
    if not takes(img):
        raise ValueError("jitter_normalize takes uint8 or float "
                         "[n, W, H, 3] images")
    if img.dtype == np.uint8:
        kind = _UINT8
    else:
        # the float checks of transforms2d._to_unit_float / normalize_images
        img = np.asarray(img, np.float32)
        if draws is not None and img.size and img.min() < -0.01:
            raise ValueError(
                "radiometric transform applied to already-normalized images "
                "(negative values present); apply it before normalize_images")
        kind = (_BYTE_FLOAT if img.size and img.max() > 1.5
                else _UNIT_FLOAT)
    img = np.ascontiguousarray(img)
    n, w, h = img.shape[:3]
    clip = draws is not None
    draws = list(draws or ())
    ops = np.array([_OPS[op] for op, _ in draws], np.int32)
    factors = np.ascontiguousarray(
        np.stack([np.asarray(f, np.float32).reshape(n) for _, f in draws])
        if draws else np.zeros((0, n), np.float32))
    out = np.empty((n, w, h, 3), np.float32)
    if out.size == 0:
        return out
    lib = _lib()
    means = np.zeros(n, np.float32)
    if _OPS["contrast"] in ops:
        k = int(np.flatnonzero(ops == _OPS["contrast"])[0])
        gray = np.empty((n, w, h), np.float32)
        _check(lib.dva_jitter_gray(_ptr(img), kind, n, w * h, _ptr(ops), k,
                                   _ptr(factors), _ptr(gray), int(threads)),
               "dva_jitter_gray")
        # numpy's own reduction, on the layout color_jitter reduces
        means = np.ascontiguousarray(
            gray[..., None].mean(axis=(1, 2, 3), keepdims=True).reshape(n))
    _check(lib.dva_jitter_normalize(
        _ptr(img), kind, n, w * h, _ptr(ops), len(ops), _ptr(factors),
        _ptr(means), int(clip), _ptr(_MEAN), _ptr(_STD),
        _ptr(out), int(threads)), "dva_jitter_normalize")
    return out
