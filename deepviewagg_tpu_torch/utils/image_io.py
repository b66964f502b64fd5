"""PNG and JPEG read / write and Pillow-equal bilinear resizing, stdlib
``zlib`` + numpy.

The JAX package reads the 2D-3D-S panoramas and the ScanNet frames with PIL
(``deepviewagg_tpu/data/datasets/s3dis.py::_load_image``:
``Image.open(path).convert("RGB")``, then ``resize(size, Image.BILINEAR)``
when the size differs).  The port has no PIL: :func:`read_png` decodes the
non-interlaced 8-bit greyscale, RGB, RGBA and palette PNGs (what the
2D-3D-S release holds; ``convert("RGB")`` takes them all);
:func:`read_jpeg` decodes baseline (and extended sequential) Huffman-coded
8-bit JPEGs of one or three components at 4:4:4, 4:2:2 or 4:2:0, with
restart intervals and any Huffman tables, reproducing libjpeg-turbo's
default decode as Pillow runs it (the ``jidctint.c`` islow IDCT,
``jdsample.c``'s fancy upsampling, ``jdcolor.c``'s fixed-point YCbCr ->
RGB); :func:`resize_bilinear` is Pillow's convolution resampling with its
triangle filter (``libImaging/Resample.c``: separable, horizontal pass
first, support scaled by the downscale factor, coefficients normalised and
rounded to 22-bit fixed point, a ``uint8`` clip after each pass), so that
:func:`load_image` gives the bytes ``_load_image`` gives.

The PNG row filters None, Sub and Up run vectorised per row; Avg and Paeth
take the reconstructed byte to the left, so they loop over the row in
Python (about 1.5 and 3 ms for a 2048-pixel RGB row).  The JPEG Huffman
walk is sequential Python too, table-driven (a 16-bit peek gives a code's
length and symbol); the IDCT, upsampling and colour conversion are
vectorised over all blocks.  Native decoders are ROADMAP A.5.
:func:`write_jpeg` and :func:`write_png` write the layouts that the tests
and ``chip_smoke.py`` build; :func:`encode_png` gives the PNG's bytes (the
HTML viewer's panels).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["read_png", "write_png", "encode_png", "read_jpeg", "write_jpeg",
           "jpeg_size", "to_rgb", "resize_bilinear", "load_image"]

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
    """``convert("RGB")`` of a :func:`read_png` or :func:`read_jpeg` array:
    greyscale is repeated over three channels, alpha dropped."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _paeth_predict(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None,
              level: int = 6) -> None:
    """Write ``uint8 [H, W, C]`` (C = 1, 3 or 4) as an 8-bit PNG: the bytes
    of :func:`encode_png`."""
    data = encode_png(img, filters, level)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray,
               filters: Union[None, int, Sequence[int]] = None,
               level: int = 6) -> bytes:
    """``uint8 [H, W, C]`` (C = 1, 3 or 4) as the bytes of an 8-bit PNG.

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

    return b"".join([
        _SIGNATURE,
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0,
                                   0)),
        chunk(b"IDAT", zlib.compress(scan.tobytes(), level)),
        chunk(b"IEND", b"")])


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
    package's ``s3dis.py::_load_image``: decode (PNG or JPEG, told apart by
    the file's signature), ``convert("RGB")``, a bilinear resize to ``size =
    (W, H)`` when the size differs."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIGNATURE:
        img = read_png(path)
    elif head[:2] == b"\xff\xd8":
        img = read_jpeg(path)
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    img = to_rgb(img)
    if (img.shape[1], img.shape[0]) != tuple(size):
        img = resize_bilinear(img, size)
    return img.transpose(1, 0, 2)


# --- JPEG ----------------------------------------------------------------

def _zigzag() -> np.ndarray:
    """``natural[k]``: the row-major index of zigzag position ``k``
    (libjpeg's ``jpeg_natural_order``)."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[1] if (rc[0] + rc[1]) % 2 == 0
                                   else rc[0]))
    return np.array([r * 8 + c for r, c in order], np.int64)


_NATURAL = _zigzag()
# the post-IDCT range limit of jdmaster.c (``prepare_range_limit_table``),
# indexed by ``x & RANGE_MASK``: x + 128 clipped to 0..255 for x in
# -384..383, the table wrapping past it
_RANGE_MASK = 1023
_IDCT_LIMIT = np.concatenate([
    np.minimum(np.arange(512) + 128, 255), np.zeros(384, np.int64),
    np.arange(128)]).astype(np.uint8)
_SOF_KINDS = {0xC0: None, 0xC1: None, 0xC2: "progressive",
              0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
              0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
              0xCF: "arithmetic-coded"}

# Annex K's tables, as libjpeg writes them (jcparam.c): quantisation in
# natural order, Huffman as (bits, values)
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99], np.int64),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
             + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38, np.int64),
)
_STD_DC = bytes.fromhex("00010501010101010100000000000000"
                        "000102030405060708090a0b")
_STD_DC_CHROMA = bytes.fromhex("00030101010101010101010000000000"
                               "000102030405060708090a0b")
_STD_AC = bytes.fromhex(
    "0002010303020403050504040000017d"
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_STD_AC_CHROMA = bytes.fromhex(
    "00020102040403040705040400010277"
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")


def _huffman_codes(counts, values):
    """Canonical codes: ``(code, length, symbol)`` per value (Annex C)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((code, length, values[k]))
            code += 1
            k += 1
        code <<= 1
    return out


def _huffman_lut(counts, values) -> list:
    """The decode table: for every 16-bit peek, ``length << 8 | symbol`` of
    the code it starts with (0: no code)."""
    lut = np.zeros(1 << 16, np.int64)
    for code, length, sym in _huffman_codes(counts, values):
        shift = 16 - length
        lut[code << shift:(code + 1) << shift] = (length << 8) | sym
    return lut.tolist()


def _markers(data: bytes, start: int = 0) -> np.ndarray:
    """Positions of the 0xFF bytes of ``data[start:-1]`` (each followed by
    one more byte)."""
    b = np.frombuffer(data, np.uint8)
    return start + np.nonzero(b[start:-1] == 0xFF)[0]


def _restart_pieces(entropy: bytes) -> list:
    """The entropy-coded data split at its RST markers."""
    ff = _markers(entropy)
    nxt = np.frombuffer(entropy, np.uint8)[ff + 1]
    cuts = ff[(nxt >= 0xD0) & (nxt <= 0xD7)].tolist()
    bounds = zip([0] + [c + 2 for c in cuts], cuts + [len(entropy)])
    return [entropy[a:b] for a, b in bounds]


def _segments(data: bytes, path: str):
    """``(marker, body)`` of every marker segment up to EOI; for a scan
    (SOS) the body is ``(header, entropy-coded data)``."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    while pos < len(data):
        while data[pos:pos + 2] == b"\xff\xff":     # fill bytes
            pos += 1
        if data[pos] != 0xFF or pos + 2 > len(data):
            raise ValueError(f"{path}: corrupt marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:
            return
        if pos + 4 > len(data):
            break
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            # the entropy-coded data runs to the first 0xFF that is neither
            # stuffing (0xFF00) nor a restart marker (0xFFD0-D7)
            ff = _markers(data, pos)
            nxt = np.frombuffer(data, np.uint8)[ff + 1]
            end = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
            stop = int(end[0]) if len(end) else len(data)
            yield marker, (body, data[pos:stop])
            pos = stop
        else:
            yield marker, body
    raise ValueError(f"{path}: truncated JPEG (no EOI)")


def _frame(body: bytes, marker: int, path: str) -> dict:
    kind = _SOF_KINDS[marker]
    if kind is not None:
        raise ValueError(f"{path}: {kind} JPEGs are not supported")
    precision, height, width, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit JPEGs are not supported")
    if nc == 4:
        raise ValueError(f"{path}: CMYK JPEGs are not supported")
    if nc not in (1, 3):
        raise ValueError(f"{path}: {nc}-component JPEGs are not supported")
    comps = []
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if nc == 1:                       # a lone component is never subsampled
        comps[0].update(h=1, v=1)
        hmax = vmax = 1
    for c in comps:
        if (hmax // c["h"], vmax // c["v"]) not in ((1, 1), (2, 1), (2, 2)) \
                or hmax % c["h"] or vmax % c["v"]:
            raise ValueError(f"{path}: sampling factors "
                             f"{[(d['h'], d['v']) for d in comps]} are not "
                             "supported (4:4:4, 4:2:2 and 4:2:0 are)")
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        # the component's own size in samples
        c["cw"] = -(-width * c["h"] // hmax)
        c["ch"] = -(-height * c["v"] // vmax)
    return dict(width=width, height=height, comps=comps, hmax=hmax,
                vmax=vmax, mcux=mcux, mcuy=mcuy)


def _windows(segment: bytes) -> list:
    """48-bit big-endian windows at every byte of an unstuffed segment
    (zero bits past its end, as libjpeg pads)."""
    b = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
    n = len(segment) + 1
    w = np.zeros(n, np.int64)
    for i in range(6):
        w = (w << 8) | b[i:i + n]
    return w.tolist()


def _decode_mcus(windows, mcus, slots, coefs, path):
    """Huffman-decode the MCUs ``mcus`` (``[n, blocks]`` block indices into
    ``coefs``, zigzag order, 64 per block) from one restart interval:
    table-driven, a 16-bit peek gives the code length and symbol, the
    window holds the extra bits after it.  ``slots``: per block of an MCU
    its component and (DC, AC) tables."""
    pred = [0] * (max(c for c, _, _ in slots) + 1)
    p = 0
    for blocks in mcus:
        for b, (c, dc, ac) in zip(blocks, slots):
            v = windows[p >> 3]
            off = p & 7
            e = dc[(v >> (32 - off)) & 0xFFFF]
            if not e:
                raise ValueError(f"{path}: bad Huffman code")
            length, s = e >> 8, e & 255
            if s:
                val = (v >> (48 - off - length - s)) & ((1 << s) - 1)
                if val < (1 << (s - 1)):
                    val -= (1 << s) - 1
                pred[c] += val
            p += length + s
            base = b * 64
            coefs[base] = pred[c]
            k = 1
            while k < 64:
                v = windows[p >> 3]
                off = p & 7
                e = ac[(v >> (32 - off)) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: bad Huffman code")
                length, rs = e >> 8, e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise ValueError(f"{path}: AC run past the block")
                    val = (v >> (48 - off - length - s)) & ((1 << s) - 1)
                    if val < (1 << (s - 1)):
                        val -= (1 << s) - 1
                    coefs[base + k] = val
                    p += length + s
                    k += 1
                else:
                    p += length
                    if rs != 0xF0:          # EOB
                        break
                    k += 16


def _scan(frame, body, entropy, huff, restart, coefs, offsets, path):
    """Decode one baseline scan into ``coefs``."""
    ns = body[0]
    by_id = {c["id"]: i for i, c in enumerate(frame["comps"])}
    scan = []
    for j in range(ns):
        cid, t = body[1 + 2 * j:3 + 2 * j]
        if cid not in by_id:
            raise ValueError(f"{path}: scan names unknown component {cid}")
        scan.append((by_id[cid], t >> 4, t & 15))
    slots = []
    if ns == 1:
        # a non-interleaved scan: one block per MCU over the component's own
        # size, in raster order
        ci, _, _ = scan[0]
        c = frame["comps"][ci]
        bw, bh = -(-c["cw"] // 8), -(-c["ch"] // 8)
        rows, cols = np.mgrid[0:bh, 0:bw]
        mcus = (offsets[ci] + rows * c["bw"] + cols).reshape(-1, 1)
    else:
        my, mx = np.mgrid[0:frame["mcuy"], 0:frame["mcux"]]
        layout = []
        for ci, _, _ in scan:
            c = frame["comps"][ci]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    layout.append(offsets[ci] + (my * c["v"] + v) * c["bw"]
                                  + mx * c["h"] + h)
        mcus = np.stack([b.reshape(-1) for b in layout], axis=1)
    for ci, td, ta in scan:
        c = frame["comps"][ci]
        reps = 1 if ns == 1 else c["h"] * c["v"]
        if (0, td) not in huff or (1, ta) not in huff:
            raise ValueError(f"{path}: scan uses an undefined Huffman table")
        slots += [(ci, huff[(0, td)], huff[(1, ta)])] * reps
    pieces = _restart_pieces(entropy) if restart else [entropy]
    per = restart or len(mcus)
    mcus = mcus.tolist()
    for i, piece in enumerate(pieces):
        chunk = mcus[i * per:(i + 1) * per]
        if not chunk:
            break
        # fill bytes may stand before a marker
        piece = piece.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
        _decode_mcus(_windows(piece), chunk, slots, coefs, path)


def _idct_1d(z, pass1: bool):
    """One pass of ``jidctint.c``'s islow IDCT over 8 arrays (the inputs of
    a column in pass 1, of a row in pass 2); int64, CONST_BITS 13,
    PASS1_BITS 2.  Returns the 8 outputs, descaled."""
    z0, z1, z2, z3, z4, z5, z6, z7 = z
    # even part
    t = (z2 + z6) * 4433                          # FIX_0_541196100
    tmp2 = t + z6 * -15137                        # FIX_1_847759065
    tmp3 = t + z2 * 6270                          # FIX_0_765366865
    tmp0 = (z0 + z4) << 13
    tmp1 = (z0 - z4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    # odd part
    o0, o1, o2, o3 = z7, z5, z3, z1
    a1, a2, a3, a4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    a5 = (a3 + a4) * 9633                         # FIX_1_175875602
    o0 = o0 * 2446                                # FIX_0_298631336
    o1 = o1 * 16819                               # FIX_2_053119869
    o2 = o2 * 25172                               # FIX_3_072711026
    o3 = o3 * 12299                               # FIX_1_501321110
    a1 = a1 * -7373                               # FIX_0_899976223
    a2 = a2 * -20995                              # FIX_2_562915447
    a3 = a3 * -16069 + a5                         # FIX_1_961570560
    a4 = a4 * -3196 + a5                          # FIX_0_390180644
    o0 = o0 + a1 + a3
    o1 = o1 + a2 + a4
    o2 = o2 + a2 + a3
    o3 = o3 + a1 + a4
    n = 13 - 2 if pass1 else 13 + 2 + 3
    r = 1 << (n - 1)
    return [(tmp10 + o3 + r) >> n, (tmp11 + o2 + r) >> n,
            (tmp12 + o1 + r) >> n, (tmp13 + o0 + r) >> n,
            (tmp13 - o0 + r) >> n, (tmp12 - o1 + r) >> n,
            (tmp11 - o2 + r) >> n, (tmp10 - o3 + r) >> n]


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """``int64 [N, 8, 8]`` dequantised coefficients (row = vertical
    frequency) -> ``uint8 [N, 8, 8]`` samples, bit-equal to libjpeg-turbo's
    ``jpeg_idct_islow`` (its all-zero shortcuts give the same numbers)."""
    cols = _idct_1d([blocks[:, r, :] for r in range(8)], pass1=True)
    ws = np.stack(cols, axis=1)                   # [N, row, col]
    rows = _idct_1d([ws[:, :, c] for c in range(8)], pass1=False)
    out = np.stack(rows, axis=2)                  # [N, row, col]
    return _IDCT_LIMIT[out & _RANGE_MASK]


def _upsample_h2(x: np.ndarray) -> np.ndarray:
    """``jdsample.c``'s ``h2v1_fancy_upsample`` of ``[H, w]``: 3/4 nearer +
    1/4 further column, ``+1 >> 2`` on even and ``+2 >> 2`` on odd
    outputs; edge columns replicated."""
    x = x.astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _upsample_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample`` of ``[h, w]``: column sums ``3 * nearer row +
    further row`` (context rows replicated at the top and bottom), then
    ``3/4 - 1/4`` across columns with ``+8 >> 4`` on even and ``+7 >> 4``
    on odd outputs; edge columns replicated."""
    x = x.astype(np.int64)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for v, other in ((0, above), (1, below)):
        cs = 3 * x + other
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * cs + left + 8) >> 4
        out[v::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Upsample a component's ``[h, w]`` samples by ``(fh, fv)``: fancy
    (triangle) filtering where the component is wider than 2 samples, else
    replication, as libjpeg-turbo chooses."""
    if (fh, fv) == (1, 1):
        return plane.astype(np.int64)
    if plane.shape[1] <= 2:
        return np.repeat(np.repeat(plane.astype(np.int64), fv, 0), fh, 1)
    return _upsample_h2v2(plane) if fv == 2 else _upsample_h2(plane)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c``'s fixed-point YCbCr -> RGB (SCALEBITS 16): the Cr->R
    and Cb->B terms rounded alone, the two green terms summed before one
    shift."""
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cb = cb - 128
    cr = cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def jpeg_size(path: str) -> tuple:
    """``(W, H)`` of a JPEG file, read from its frame header (what
    ``Image.open(path).size`` gives)."""
    with open(path, "rb") as f:
        data = f.read()
    for marker, body in _segments(data, path):
        if marker in _SOF_KINDS:
            height, width = struct.unpack(">HH", body[1:5])
            return width, height
    raise ValueError(f"{path}: JPEG without a frame header")


def read_jpeg(path: str) -> np.ndarray:
    """Decode a baseline (or extended sequential) Huffman-coded 8-bit JPEG
    -> ``uint8 [H, W, C]``, C = 1 (greyscale) or 3 (RGB), byte-equal to
    libjpeg-turbo's default decode (what Pillow gives): the islow integer
    IDCT, fancy upsampling of 4:2:2 / 4:2:0 chroma, the fixed-point
    YCbCr -> RGB.  Progressive, arithmetic-coded, lossless, hierarchical,
    12-bit and CMYK files raise, naming what they are."""
    with open(path, "rb") as f:
        data = f.read()
    frame, qt, huff, restart = None, {}, {}, 0
    adobe, jfif = None, False
    coefs = offsets = None
    for marker, body in _segments(data, path):
        if marker in _SOF_KINDS:
            frame = _frame(body, marker, path)
            sizes = [c["bw"] * c["bh"] for c in frame["comps"]]
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
            coefs = [0] * (64 * sum(sizes))
        elif marker == 0xDB:
            pos = 0
            while pos < len(body):
                pq, tq = body[pos] >> 4, body[pos] & 15
                n = 128 if pq else 64
                qt[tq] = np.frombuffer(body[pos + 1:pos + 1 + n],
                                       ">u2" if pq else np.uint8
                                       ).astype(np.int64)
                pos += 1 + n
        elif marker == 0xC4:
            pos = 0
            while pos < len(body):
                tc, th = body[pos] >> 4, body[pos] & 15
                counts = body[pos + 1:pos + 17]
                values = body[pos + 17:pos + 17 + sum(counts)]
                huff[(tc, th)] = _huffman_lut(counts, values)
                pos += 17 + sum(counts)
        elif marker == 0xDD:
            restart, = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            head, entropy = body
            _scan(frame, head, entropy, huff, restart, coefs, offsets, path)
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEGs are not "
                             "supported")
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    width, height = frame["width"], frame["height"]
    coef = np.asarray(coefs, np.int64).reshape(-1, 64)
    planes = []
    for c, off in zip(frame["comps"], offsets):
        if c["tq"] not in qt:
            raise ValueError(f"{path}: undefined quantisation table")
        blk = coef[off:off + c["bw"] * c["bh"]] * qt[c["tq"]][None]
        nat = np.empty_like(blk)
        nat[:, _NATURAL] = blk
        samples = _idct_islow(nat.reshape(-1, 8, 8))
        plane = samples.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["ch"], :c["cw"]]
        up = _upsample(plane, frame["hmax"] // c["h"],
                       frame["vmax"] // c["v"])
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[..., None]
    ids = [c["id"] for c in frame["comps"]]
    # libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == [82, 71, 66]
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _quant_table(table: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality`` scaling of a base table (baseline:
    entries clipped to 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((table * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


def _blocks(plane: np.ndarray, bw: int, bh: int) -> np.ndarray:
    """``[bh * bw, 8, 8]`` blocks of a plane padded by edge replication."""
    h, w = plane.shape
    padded = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(
        -1, 8, 8)


def _code_table(spec: bytes):
    """``(code, length)`` arrays indexed by symbol of a (bits, values)
    Huffman table."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for c, n, sym in _huffman_codes(spec[:16], spec[16:]):
        code[sym], length[sym] = c, n
    return code, length


def _entropy_code(zz: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code quantised blocks ``[N, 64]`` (zigzag order, in scan
    order; ``comp`` each block's table set) with byte stuffing and 1-bit
    padding, vectorised: each symbol becomes one ``(value, bits)`` event,
    ordered by block and position."""
    n = len(zz)
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(np.concatenate([[0], dc[sel]]))
    bi, ki = np.nonzero(zz[:, 1:])
    k = ki + 1
    val = zz[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    last = np.zeros(n, np.int64)
    last[bi] = k                       # the last nonzero of each block

    def size(v):
        return np.where(v == 0, 0, np.floor(np.log2(np.abs(v) + 0.5)) + 1
                        ).astype(np.int64)

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)

    events = []                         # (key, value, bits)
    dsize = size(diff)
    dcode = np.zeros(n, np.int64)
    dlen = np.zeros(n, np.int64)
    for c, (dc_t, _) in enumerate(tables):
        sel = comp == c
        dcode[sel], dlen[sel] = dc_t[0][dsize[sel]], dc_t[1][dsize[sel]]
    events.append((np.arange(n) * 256, (dcode << dsize) | extra(diff, dsize),
                   dlen + dsize))
    zrl = run // 16
    sym = ((run % 16) << 4) | size(val)
    acode = np.zeros(len(bi), np.int64)
    alen = np.zeros(len(bi), np.int64)
    zcode = np.zeros(len(bi), np.int64)
    zlen = np.zeros(len(bi), np.int64)
    eob_code = np.zeros(n, np.int64)
    eob_len = np.zeros(n, np.int64)
    for c, (_, ac_t) in enumerate(tables):
        sel = comp[bi] == c
        acode[sel], alen[sel] = ac_t[0][sym[sel]], ac_t[1][sym[sel]]
        zcode[sel], zlen[sel] = ac_t[0][0xF0], ac_t[1][0xF0]
        bsel = comp == c
        eob_code[bsel], eob_len[bsel] = ac_t[0][0], ac_t[1][0]
    vs = size(val)
    rep = np.repeat(np.arange(len(bi)), zrl)
    events.append((bi[rep] * 256 + 2 * k[rep], zcode[rep], zlen[rep]))
    events.append((bi * 256 + 2 * k + 1, (acode << vs) | extra(val, vs),
                   alen + vs))
    eob = np.nonzero(last < 63)[0]
    events.append((eob * 256 + 255, eob_code[eob], eob_len[eob]))
    keys = np.concatenate([e[0] for e in events])
    order = np.argsort(keys, kind="stable")
    values = np.concatenate([e[1] for e in events])[order]
    nbits = np.concatenate([e[2] for e in events])[order]
    total = int(nbits.sum())
    starts = np.cumsum(nbits) - nbits
    owner = np.repeat(np.arange(len(nbits)), nbits)
    j = np.arange(total) - starts[owner]
    bits = (values[owner] >> (nbits[owner] - 1 - j)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    out = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    """Write ``uint8 [H, W, 3]`` (or ``[H, W]`` / ``[H, W, 1]`` greyscale) as
    a baseline JFIF JPEG: colour at 4:2:0 (Y 2x2, Cb and Cr 1x1, chroma
    averaged over 2 x 2), Annex K's quantisation tables scaled to
    ``quality`` as libjpeg scales them, its standard Huffman tables, a
    float DCT.  For the layouts the tests and the smoke run write (the
    card's machine has no PIL)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"write_jpeg takes uint8 [H, W, 1 | 3], got "
                         f"{img.dtype} {img.shape}")
    h, w, nc = img.shape
    x = img.astype(np.float64)
    if nc == 3:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
        mcux, mcuy = -(-w // 16), -(-h // 16)
        # chroma: 2 x 2 means over the edge-replicated plane
        for i in (1, 2):
            p = np.pad(planes[i], ((0, mcuy * 16 - h), (0, mcux * 16 - w)),
                       mode="edge")
            planes[i] = p.reshape(mcuy * 8, 2, mcux * 8, 2).mean(axis=(1, 3))
        grids = [(2 * mcux, 2 * mcuy), (mcux, mcuy), (mcux, mcuy)]
    else:
        planes = [x[..., 0]]
        grids = [(-(-w // 8), -(-h // 8))]
    qts = [_quant_table(t, quality) for t in _STD_QUANT]
    m = _dct_matrix()
    blocks = []
    for i, (plane, (bw, bh)) in enumerate(zip(planes, grids)):
        blk = _blocks(plane, bw, bh) - 128.0
        coef = m @ blk @ m.T
        q = qts[min(i, 1)].reshape(8, 8)
        quant = np.round(coef / q).astype(np.int64).reshape(-1, 64)
        blocks.append(quant[:, _NATURAL].reshape(bh, bw, 64))
    if nc == 3:
        # interleaved MCUs: four Y blocks (row-major), then Cb, then Cr
        y = blocks[0].reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
        mcus = np.concatenate([y.reshape(mcuy, mcux, 4, 64),
                               blocks[1][:, :, None], blocks[2][:, :, None]],
                              axis=2)
        zz = mcus.reshape(-1, 64)
        comp = np.tile([0, 0, 0, 0, 1, 2], mcuy * mcux)
        tab = [0, 1, 1]
    else:
        zz = blocks[0].reshape(-1, 64)
        comp = np.zeros(len(zz), np.int64)
        tab = [0]
    specs = [(_STD_DC, _STD_AC), (_STD_DC_CHROMA, _STD_AC_CHROMA)]
    tables = [tuple(_code_table(t) for t in specs[tab[c]])
              for c in range(nc)]
    scan = _entropy_code(zz, comp, tables)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8",
           seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(1 if nc == 1 else 2):
        out.append(seg(0xDB, bytes([t]) + qts[t][_NATURAL].astype(
            np.uint8).tobytes()))
    sampling = [0x22, 0x11, 0x11] if nc == 3 else [0x11]
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, sampling[c], tab[c]]) for c in range(nc))))
    for t in range(1 if nc == 1 else 2):
        out.append(seg(0xC4, bytes([t]) + specs[t][0]))
        out.append(seg(0xC4, bytes([0x10 | t]) + specs[t][1]))
    out.append(seg(0xDA, bytes([nc]) + b"".join(
        bytes([c + 1, (tab[c] << 4) | tab[c]]) for c in range(nc))
        + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(b"".join(out))
