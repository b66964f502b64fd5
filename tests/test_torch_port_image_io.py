"""The port's PNG reader, writer and bilinear resize against Pillow, which
the JAX package reads the 2D-3D-S panoramas with and which the card's
machine lacks.

``read_png`` is byte-equal to PIL's decode on files PIL writes (RGB, RGBA,
L and P, at sizes where PIL's encoder picks several row filters); it
refuses sub-byte depths and greyscale + alpha by name; ``write_png``'s files, every row filter
forced or chosen per row, decode in PIL to the array written;
``resize_bilinear`` is byte-equal to ``Image.resize(size, BILINEAR)`` at a
4x and a 2x downscale, a non-integer ratio and an upscale; ``load_image`` is
``deepviewagg_tpu/data/datasets/s3dis.py::_load_image``."""

import struct
import zlib

import numpy as np
import pytest

from deepviewagg_tpu.data.datasets import s3dis as js
from deepviewagg_tpu_torch.utils import image_io

Image = pytest.importorskip("PIL.Image")


def _photo(h, w, c, seed=0):
    """Smooth gradients plus noise: rows that PIL's adaptive filtering
    encodes with different filter types."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 17.0)[..., None] * 60 + np.cos(y / 11.0)[..., None]
            * 50 + 120 + rng.normal(0, 8, (h, w, c)))
    return np.clip(base, 0, 255).astype(np.uint8)


def _filter_types(path):
    """The set of row filter types in a PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, []
    while True:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(b"".join(idat))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    stride = (w * channels * depth + 7) // 8
    return {raw[i * (stride + 1)] for i in range(h)}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("hw", [(37, 53), (128, 256)])
def test_read_png_equals_pil(tmp_path, mode, hw):
    c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = _photo(*hw, c)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr if c > 1 else arr[..., 0], mode).save(path)
    assert len(_filter_types(path)) >= 3
    ref = np.asarray(Image.open(path))
    got = image_io.read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref if ref.ndim == 3 else ref[..., None])
    np.testing.assert_array_equal(
        image_io.to_rgb(got), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("colors", [17, 64, 200, 256])
def test_read_png_palette_equals_pil(tmp_path, colors):
    """PIL writes palettes of more than 16 colours at 8 bits."""
    path = str(tmp_path / "p.png")
    Image.fromarray(_photo(40, 61, 3)).quantize(colors).save(path)
    got = image_io.read_png(path)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path).convert("RGB")))
    assert len(np.unique(got.reshape(-1, 3), axis=0)) <= colors


@pytest.mark.parametrize("case", ["P2", "P4", "P16", "1", "LA"])
def test_sub_byte_and_grey_alpha_pngs_raise(tmp_path, case):
    """Palettes of 2, 4 and 16 colours (PIL writes them at 1, 2 and 4
    bits), 1-bit greyscale and greyscale + alpha: none is in the 2D-3D-S
    release, and ``read_png`` refuses each by name."""
    path = str(tmp_path / "x.png")
    photo = _photo(30, 45, 3)
    if case.startswith("P"):
        img = Image.fromarray(photo).quantize(int(case[1:]))
    elif case == "1":
        img = Image.fromarray(photo[..., 0] > 128)
    else:
        img = Image.fromarray(photo[..., :2], "LA")
    img.save(path)
    match = "colour type 4" if case == "LA" else "-bit PNGs"
    with pytest.raises(ValueError, match=match):
        image_io.read_png(path)


@pytest.mark.parametrize("content", ["photo", "ties"])
@pytest.mark.parametrize("filters", [None, 0, 1, 2, 3, 4, "cycle"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_write_png_round_trips_through_pil(tmp_path, filters, c, content):
    """``ties``: three levels 100 apart, so that the Paeth predictor's
    distances tie often (left and up on either side of up-left)."""
    arr = _photo(60, 77, c) if content == "photo" else (
        np.random.default_rng(3).integers(0, 3, (60, 77, c)) * 100
    ).astype(np.uint8)
    kinds = [i % 5 for i in range(60)] if filters == "cycle" else filters
    path = str(tmp_path / "w.png")
    image_io.write_png(path, arr, filters=kinds)
    want = {0, 1, 2, 3, 4} if filters == "cycle" else (
        {filters} if filters is not None else None)
    if want is not None:
        assert _filter_types(path) == want
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref if ref.ndim == 3 else ref[..., None],
                                  arr)
    np.testing.assert_array_equal(image_io.read_png(path), arr)


@pytest.mark.parametrize("src,dst", [
    ((2048, 1024), (512, 256)), ((256, 128), (128, 64)),
    ((2048, 1024), (1024, 512)), ((200, 100), (77, 41)),
    ((64, 32), (150, 70)), ((100, 50), (100, 30)), ((100, 50), (61, 50))],
    ids=["4x", "2x", "2x_panorama", "non_integer", "upscale", "height_only",
         "width_only"])
def test_resize_bilinear_equals_pil(src, dst):
    arr = _photo(src[1], src[0], 3, seed=1)
    ref = np.asarray(Image.fromarray(arr).resize(dst, Image.BILINEAR))
    got = image_io.resize_bilinear(arr, dst)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("size", [(128, 64), (64, 32), (100, 40)])
def test_load_image_equals_the_jax_loader(tmp_path, mode, size):
    arr = _photo(64, 128, 3, seed=2)
    img = Image.fromarray(arr)
    img = img.quantize(64) if mode == "P" else img.convert(mode)
    path = str(tmp_path / "pano.png")
    img.save(path)
    ref = js._load_image(path, size)
    got = image_io.load_image(path, size)
    assert got.shape == (size[0], size[1], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def _with_header(path, depth=None, interlace=None):
    """Rewrite the IHDR chunk of a PNG file (its CRC recomputed)."""
    data = bytearray(open(path, "rb").read())
    body = bytearray(data[16:29])
    if depth is not None:
        body[8] = depth
    if interlace is not None:
        body[12] = interlace
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    open(path, "wb").write(bytes(data))


def test_unsupported_pngs_raise(tmp_path):
    """Adam7, 16-bit samples, a bad CRC and a file that is no PNG raise;
    PIL reads the same header fields."""
    path = str(tmp_path / "i.png")
    image_io.write_png(path, _photo(8, 8, 3))
    _with_header(path, interlace=1)
    assert Image.open(path).info.get("interlace") == 1
    with pytest.raises(ValueError, match="interlaced"):
        image_io.read_png(path)
    image_io.write_png(path, _photo(8, 8, 3))
    _with_header(path, depth=16)
    assert Image.open(path).mode == "RGB" and Image.open(path).size == (8, 8)
    with pytest.raises(ValueError, match="16-bit"):
        image_io.read_png(path)
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 1                     # the IEND chunk's CRC
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(path)
    open(path, "wb").write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(path)
