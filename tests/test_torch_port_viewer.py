"""The port's HTML viewer (``visualization/viewer.py::export_html``) and
demo (``cli/demo_synthetic.py``) against the JAX package's.

The JAX viewer writes its image panels with PIL, the port with its own PNG
encoder (``utils/image_io.py::encode_png``; the card's machine has no PIL),
so the PNG bytes differ.  Held exact: the page outside its data, the data's
JSON field by field (points, colour modes, overlays, sizes, title), and each
panel decoded pixel by pixel (by PIL and by the port's ``read_png``).
"""

import base64
import dataclasses
import functools
import io
import json

import numpy as np
import pytest
from PIL import Image

from deepviewagg_tpu.data import toy as jtoy
from deepviewagg_tpu.visualization import viewer as jviewer
from deepviewagg_tpu_torch.data import mapping as tmapping
from deepviewagg_tpu_torch.utils import image_io
from deepviewagg_tpu_torch.visualization import viewer as tviewer
from torch_port_util import _torch_threads  # noqa: F401

PREFIX = "const D = "


@functools.lru_cache(maxsize=None)
def _sample():
    """One JAX toy sample: about 1,600 points, two 64 x 32 images and their
    mapping."""
    return jtoy.toy_samples(n_samples=1, density=40.0, image_size=(64, 32),
                            n_cameras=2)[0]


def _port_mapping(m):
    return tmapping.MultiViewMapping(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


def _split(path):
    """(the page with its data cut out, the data)."""
    html = open(path).read()
    start = html.index(PREFIX) + len(PREFIX)
    end = html.index(";\ndocument.getElementById('title')", start)
    return html[:start] + html[end:], json.loads(html[start:end])


def _decode_pil(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _decode_port(b64, tmp_path):
    path = tmp_path / "panel.png"
    path.write_bytes(base64.b64decode(b64))
    return image_io.read_png(str(path))


CASES = {
    "everything": lambda s: dict(rgb=s.feats[:, :3], labels=s.labels,
                                 preds=(s.labels + 1) % 7 - 1,
                                 images=s.images, mapping=s.mapping),
    "no_colours": lambda s: dict(images=s.images),
    "subsampled": lambda s: dict(rgb=s.feats[:, :3], max_points=500,
                                 title="a sample"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_html_matches_jax(case, tmp_path):
    s = _sample()
    kw = CASES[case](s)
    want_page, want = _split(jviewer.export_html(
        str(tmp_path / "jax" / "v.html"), s.pos, **kw))
    if "mapping" in kw:
        kw["mapping"] = _port_mapping(kw["mapping"])
    got_page, got = _split(tviewer.export_html(
        str(tmp_path / "port" / "v.html"), s.pos, **kw))
    assert got_page == want_page
    assert sorted(got) == sorted(want) == ["modes", "panels", "pos", "title"]
    for key in ("pos", "modes", "title"):
        assert got[key] == want[key], key
    assert len(got["pos"]) == min(len(s.pos), kw.get("max_points", 60_000))
    assert len(got["panels"]) == len(want["panels"]) == (
        len(s.images) if "images" in kw else 0)
    for i, (g, w) in enumerate(zip(got["panels"], want["panels"])):
        assert {k: g[k] for k in ("overlay", "w", "h")} == {
            k: w[k] for k in ("overlay", "w", "h")}
        if case == "everything":
            assert len(g["overlay"][0]) > 0
        pixels = _decode_pil(w["png"])
        assert pixels.shape == (s.images.shape[2], s.images.shape[1], 3)
        assert np.array_equal(_decode_pil(g["png"]), pixels), i
        assert np.array_equal(_decode_port(g["png"], tmp_path), pixels), i


def test_the_template_and_palette_are_the_jax_ones():
    assert tviewer._TEMPLATE == jviewer._TEMPLATE
    assert np.array_equal(tviewer._PALETTE, jviewer._PALETTE)
    labels = np.array([-3, -1, 0, 5, 19, 20, 45])
    assert np.array_equal(tviewer._label_colors(labels),
                          jviewer._label_colors(labels))


@pytest.mark.parametrize("shape", [(32, 64, 3), (17, 5, 1), (9, 12, 4)])
def test_encode_png_is_what_write_png_writes(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    image_io.write_png(str(path), img)
    data = image_io.encode_png(img)
    assert path.read_bytes() == data
    want = img[..., 0] if shape[2] == 1 else img
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), want)


def test_demo_writes_the_snapshot_and_the_viewer(tmp_path):
    """``python -m deepviewagg_tpu_torch.cli.demo_synthetic --epochs 1
    --device cpu``: the PLY holds one labelled, predicted point per voxel of
    the first sample, the viewer's data parse, and each panel decodes to its
    image's bytes."""
    from deepviewagg_tpu_torch.cli import demo_synthetic
    from deepviewagg_tpu_torch.data.toy import toy_samples
    from deepviewagg_tpu_torch.utils.ply import read_ply

    out = demo_synthetic.main(["--out", str(tmp_path), "--epochs", "1",
                               "--device", "cpu"])
    assert np.isfinite(out["metrics"]["train_loss"])
    sample = out["sample"]
    # the script's first toy sample
    again = toy_samples(n_samples=2, density=100.0, image_size=(128, 64),
                        n_cameras=2, device="cpu")[0]
    assert np.array_equal(sample.pos, again.pos)
    assert np.array_equal(sample.images, again.images)
    ply = read_ply(out["ply"])
    n = len(sample.pos)
    assert len(ply["x"]) == n == len(out["preds"])
    assert np.array_equal(ply["label"], sample.labels)
    assert np.array_equal(ply["pred"], out["preds"])
    _, data = _split(out["html"])
    assert sorted(data["modes"]) == ["labels", "preds", "rgb"]
    assert len(data["pos"]) == n
    assert data["title"] == "deepviewagg_tpu synthetic demo"
    assert len(data["panels"]) == len(sample.images) == 2
    for panel, img in zip(data["panels"], sample.images):
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 0, 2)
        assert np.array_equal(_decode_port(panel["png"], tmp_path), want)
        assert (panel["w"], panel["h"]) == (128, 64)
