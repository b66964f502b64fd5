"""PNG read / write and Pillow-equal bilinear resizing, stdlib ``zlib`` +
numpy.

The JAX package reads the 2D-3D-S panoramas with PIL
(``deepviewagg_tpu/data/datasets/s3dis.py::_load_image``:
``Image.open(path).convert("RGB")``, then ``resize(size, Image.BILINEAR)``
when the size differs).  The port has no PIL: :func:`read_png` decodes the
non-interlaced 8-bit greyscale, RGB, RGBA and palette PNGs (what the
2D-3D-S release holds; ``convert("RGB")`` takes them all), :func:`resize_bilinear` is Pillow's convolution
resampling with its triangle filter (``libImaging/Resample.c``: separable,
horizontal pass first, support scaled by the downscale factor, coefficients
normalised and rounded to 22-bit fixed point, a ``uint8`` clip after each
pass), so that :func:`load_image` gives the bytes ``_load_image`` gives.

The PNG row filters None, Sub and Up run vectorised per row; Avg and Paeth
take the reconstructed byte to the left, so they loop over the row in
Python (about 1.5 and 3 ms for a 2048-pixel RGB row; a native unfilter is
ROADMAP A.5).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["read_png", "write_png", "to_rgb", "resize_bilinear",
           "load_image"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels as stored (palette: one index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}             # channels -> colour type
_PRECISION_BITS = 32 - 8 - 2                 # Resample.c's fixed point


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _unfilter_avg(line: list, prior: list, bpp: int) -> bytes:
    cur = [0] * len(line)
    for i in range(bpp):
        cur[i] = (line[i] + (prior[i] >> 1)) & 255
    for i in range(bpp, len(line)):
        cur[i] = (line[i] + ((cur[i - bpp] + prior[i]) >> 1)) & 255
    return bytes(cur)


def _unfilter_paeth(line: list, prior: list, bpp: int) -> bytes:
    cur = [0] * len(line)
    for i in range(bpp):                     # a = c = 0: the predictor is b
        cur[i] = (line[i] + prior[i]) & 255
    for i in range(bpp, len(line)):
        a, b, c = cur[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            p = a
        elif pb <= pc:
            p = b
        else:
            p = c
        cur[i] = (line[i] + p) & 255
    return bytes(cur)


def _unfilter(raw: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Reconstruct ``uint8 [H, stride]`` from the filtered scanlines
    ``[H, 1 + stride]`` (PNG spec section 9)."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            # wrapping uint8 cumulative sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_avg(line.tolist(), prior.tolist(),
                                              bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(line.tolist(),
                                                prior.tolist(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG -> ``uint8 [H, W, C]``: C = 1
    (greyscale), 3 (RGB, and palette images looked up to RGB) or 4 (RGBA).
    Other bit depths, greyscale + alpha and Adam7 interlacing raise."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported")
    channels = _CHANNELS[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = _unfilter(raw[:height * (stride + 1)].reshape(height, stride + 1),
                     channels, path)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        idx = rows
        # indices past the palette read black, as in PIL's padded palette
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[idx]
    return rows.reshape(height, width, channels)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """``convert("RGB")`` of a :func:`read_png` array: greyscale is
    repeated over three channels, alpha dropped."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _paeth_predict(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None,
              level: int = 6) -> None:
    """Write ``uint8 [H, W, C]`` (C = 1, 3 or 4) as an 8-bit PNG.

    ``filters``: the row filter type (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth)
    of every row, or one per row; ``None`` chooses per row the type with the
    least sum of absolute filtered bytes (the PNG spec's heuristic)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 [H, W, 1 | 3 | 4], got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]
    filtered = np.stack([x, x - a, x - b, x - (a + b) // 2,
                         x - _paeth_predict(a, b, cc)]).astype(np.uint8)
    if filters is None:
        cost = np.abs(filtered.view(np.int8).astype(np.int32)).sum(axis=2)
        kinds = cost.argmin(axis=0)
    else:
        kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
        if kinds.min() < 0 or kinds.max() > 4:
            raise ValueError(f"PNG filter types are 0-4, got {filters}")
    rows = filtered[kinds, np.arange(h)]
    scan = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           _COLOR_TYPE[c], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(scan.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def _coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear (triangle, support 1) filter: per output pixel the first input
    pixel, and the fixed-point weights of ``ksize`` taps (zero past the
    pixel's own count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    arg = np.abs(((taps[None] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(arg < 1.0, 1.0 - arg, 0.0)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):                   # Resample.c's summation order
        ww = ww + w[:, t]
    k = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = np.trunc(np.where(k < 0, -0.5, 0.5)
                     + k * (1 << _PRECISION_BITS)).astype(np.int32)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's resampling along ``axis`` of ``[H, W,
    C]``: the rounding offset, the weighted taps in int32, the clip."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    shape = [1, 1, 1]
    shape[axis] = out_size
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int32) \
            * k[:, t].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """``uint8 [H, W, C]`` -> ``[size[1], size[0], C]``, byte-equal to
    Pillow's ``Image.resize(size, Image.BILINEAR)`` (``size`` is ``(W, H)``
    as for PIL): the horizontal pass first, each pass only where its size
    changes."""
    img = np.asarray(img, np.uint8)
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size}")
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, axis=1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, axis=0)
    return out if out is not img else img.copy()


def load_image(path: str, size) -> np.ndarray:
    """-> ``uint8 [W, H, 3]`` (x = width), the counterpart of the JAX
    package's ``s3dis.py::_load_image``: decode, ``convert("RGB")``, a
    bilinear resize to ``size = (W, H)`` when the size differs."""
    img = to_rgb(read_png(path))
    if (img.shape[1], img.shape[0]) != tuple(size):
        img = resize_bilinear(img, size)
    return img.transpose(1, 0, 2)
