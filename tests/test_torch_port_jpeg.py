"""The port's JPEG reader and writer against Pillow, which the JAX package
reads the ScanNet frames with and which the card's machine lacks.

``read_jpeg`` is byte-equal to ``np.asarray(Image.open(p))`` (Pillow on
libjpeg-turbo: the islow IDCT, fancy upsampling, the fixed-point YCbCr ->
RGB) on files Pillow writes: sizes that are multiples of 16 and not,
4:4:4, 4:2:2 and 4:2:0, greyscale, optimised Huffman tables, restart
intervals, qualities 50 / 75 / 95, photo-like content and noise (a Huffman
decoder's worst case).  ``load_image`` is
``deepviewagg_tpu/data/datasets/s3dis.py::_load_image`` on JPEGs;
``jpeg_size`` is ``Image.open(p).size``; Pillow decodes ``write_jpeg``'s
files to what ``read_jpeg`` gives, and its tables are libjpeg's; the
formats the reader does not take raise by name."""

import struct

import numpy as np
import pytest

from deepviewagg_tpu.data.datasets import s3dis as js
from deepviewagg_tpu_torch.utils import image_io

Image = pytest.importorskip("PIL.Image")

SIZES = [(48, 64), (37, 53), (16, 16), (240, 320), (7, 9), (1, 1)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _photo(h, w, seed=0):
    """Smooth shading, a colour gradient and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(x / 17.0 + seed) * 60 + 120 + y * 0.1,
                    np.cos(y / 13.0) * 50 + 100,
                    (x + y) % 200 * 0.5 + 50], axis=-1)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _noise(h, w, c=3, seed=1):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c)).astype(np.uint8).squeeze()


def _pil(path):
    ref = np.asarray(Image.open(path))
    return ref[..., None] if ref.ndim == 2 else ref


def _check(path):
    got = image_io.read_jpeg(path)
    ref = _pil(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    return got


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_read_jpeg_equals_pil(tmp_path, hw, sub, quality):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_photo(*hw, seed=quality)).save(
        path, quality=quality, subsampling=SUBSAMPLING[sub])
    _check(path)


@pytest.mark.parametrize("kind", ["grey", "optimize", "noise_q100",
                                  "grey_noise_optimize"])
@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (121, 97)],
                         ids=["48x64", "37x53", "121x97"])
def test_read_jpeg_equals_pil_other_files(tmp_path, hw, kind):
    """Greyscale (one non-interleaved scan), optimised Huffman tables
    (Pillow's ``optimize=True``: other DHT segments), noise at quality 100
    (long codes, every AC coefficient coded)."""
    path = str(tmp_path / "x.jpg")
    if kind == "grey":
        Image.fromarray(_photo(*hw)[..., 0]).save(path, quality=75)
    elif kind == "optimize":
        Image.fromarray(_photo(*hw)).save(path, quality=75, optimize=True)
    elif kind == "noise_q100":
        Image.fromarray(_noise(*hw)).save(path, quality=100)
    else:
        Image.fromarray(_noise(*hw, c=1)).save(path, quality=100,
                                               optimize=True)
    got = _check(path)
    assert got.shape[2] == (1 if "grey" in kind else 3)


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)],
                         ids=["blocks1", "blocks3", "rows1"])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2"])
def test_read_jpeg_restart_intervals(tmp_path, restart, sub):
    """A DRI segment: the DC predictors reset at every RST marker."""
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_photo(53, 70)).save(
        path, quality=90, subsampling=SUBSAMPLING[sub], **restart)
    assert b"\xff\xdd" in open(path, "rb").read()
    _check(path)


@pytest.mark.parametrize("size", [(320, 240), (64, 48), (53, 37)])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_load_image_equals_the_jax_loader(tmp_path, mode, size):
    """A 640 x 480 frame read at the ScanNet recipe's 320 x 240 (and
    other sizes: the resize runs), greyscale converted to RGB."""
    arr = _photo(96, 128) if mode == "RGB" else _photo(96, 128)[..., 0]
    path = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(path, quality=75)
    ref = js._load_image(path, size)
    got = image_io.load_image(path, size)
    assert got.shape == (size[0], size[1], 3) == ref.shape
    assert np.array_equal(got, ref)


def test_jpeg_size_is_pils(tmp_path):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_photo(37, 53)).save(path)
    assert image_io.jpeg_size(path) == Image.open(path).size == (53, 37)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("hw", [(480, 640), (37, 53), (5, 3)],
                         ids=["480x640", "37x53", "5x3"])
@pytest.mark.parametrize("channels", [3, 1])
def test_write_jpeg_decodes_in_pil(tmp_path, hw, quality, channels):
    """Pillow decodes ``write_jpeg``'s baseline 4:2:0 (or greyscale) file
    to what ``read_jpeg`` gives, close to the array written."""
    img = _photo(*hw)
    if channels == 1:
        img = img[..., :1]
    path = str(tmp_path / "x.jpg")
    image_io.write_jpeg(path, img, quality=quality)
    got = _check(path)
    assert image_io.jpeg_size(path) == (hw[1], hw[0])
    err = np.abs(got.astype(np.int64) - img).mean()
    assert err < 6.0
    if channels == 3:
        assert Image.open(path).mode == "RGB"
        assert Image.open(path).layer[0][1:3] == (2, 2)   # Y 2 x 2


def _segments(path):
    data = open(path, "rb").read()
    pos, out = 2, {}
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        out.setdefault(marker, []).append(data[pos + 4:pos + 2 + length])
        pos += 2 + length
    return out


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_write_jpeg_tables_are_libjpegs(tmp_path, quality):
    """The quantisation tables scaled as libjpeg scales them, and the
    standard Huffman tables: byte-equal to the DQT and DHT segments of a
    file Pillow writes at the same quality."""
    img = _photo(32, 32)
    ours, theirs = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    image_io.write_jpeg(ours, img, quality=quality)
    Image.fromarray(img).save(theirs, quality=quality)
    a, b = _segments(ours), _segments(theirs)
    assert a[0xDB] == b[0xDB]
    assert a[0xC4] == b[0xC4]
    assert a[0xC0] == b[0xC0]


def test_unsupported_jpegs_raise(tmp_path):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_photo(48, 64)).save(path, progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        image_io.read_jpeg(path)
    Image.fromarray(_photo(48, 64)).convert("CMYK").save(path)
    with pytest.raises(ValueError, match="CMYK"):
        image_io.read_jpeg(path)
    # a 12-bit and an arithmetic-coded frame header
    Image.fromarray(_photo(48, 64)).save(path)
    data = bytearray(open(path, "rb").read())
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    open(path, "wb").write(bytes(twelve))
    with pytest.raises(ValueError, match="12-bit"):
        image_io.read_jpeg(path)
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    open(path, "wb").write(bytes(arith))
    with pytest.raises(ValueError, match="arithmetic-coded"):
        image_io.read_jpeg(path)
    open(path, "wb").write(b"GIF89a" + bytes(10))
    with pytest.raises(ValueError, match="not a JPEG"):
        image_io.read_jpeg(path)
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_io.load_image(path, (4, 4))
