"""Multimodal sample visualization: per-epoch PLY dumps and a standalone
HTML viewer.

The port of ``deepviewagg_tpu/visualization/viewer.py``.  The reference's
``Visualizer`` dumps selected samples as .ply per epoch
(visualization/visualizer.py:10): :func:`save_ply_snapshot`, numpy over the
port's PLY writer, the same arrays giving the same bytes.  Its notebook
viewer (visualization/multimodal_data.py:109-899, plotly) becomes
:func:`export_html`, one self-contained HTML file (an inline canvas
renderer, no network): drag to orbit, wheel to zoom, colour-mode buttons,
image panels with mapped-pixel overlays.  The panels are PNGs written by
the port's own encoder (no PIL on the card's machine), so their bytes are
not PIL's; the pixels and the page's data are the JAX viewer's.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, Optional

import numpy as np

from ..utils.image_io import encode_png
from ..utils.ply import write_ply

__all__ = ["save_ply_snapshot", "export_html"]

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], np.uint8)


def _label_colors(labels):
    lab = np.asarray(labels, np.int64)
    c = _PALETTE[np.clip(lab, 0, len(_PALETTE) - 1) % len(_PALETTE)]
    c[lab < 0] = 40
    return c


def save_ply_snapshot(path: str, pos, rgb=None, labels=None, preds=None):
    """One .ply with positions + colors + label/pred scalars."""
    pos = np.asarray(pos, np.float32)
    fields = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    if rgb is not None:
        c = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
        fields.update(red=c[:, 0], green=c[:, 1], blue=c[:, 2])
    if labels is not None:
        fields["label"] = np.asarray(labels, np.int32)
    if preds is not None:
        fields["pred"] = np.asarray(preds, np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, fields)


def _png_b64(img_wh3: np.ndarray) -> str:
    arr = np.clip(np.asarray(img_wh3), 0, 1)
    arr = (arr * 255).astype(np.uint8).transpose(1, 0, 2)  # [W,H,3]->[H,W,3]
    return base64.b64encode(encode_png(arr)).decode()


def export_html(
    path: str,
    pos,
    rgb=None,
    labels=None,
    preds=None,
    images: Optional[np.ndarray] = None,
    mapping=None,
    max_points: int = 60_000,
    title: str = "deepviewagg sample",
):
    """Standalone interactive HTML for one (multimodal) sample: at most
    ``max_points`` points (a seeded draw), coloured by ``rgb``, ``labels``
    and ``preds`` (or height), and one panel per image ``[W, H, 3]`` in
    [0, 1] with up to 4000 of its mapped pixels overlaid."""
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    sel = (np.random.default_rng(0).choice(n, max_points, replace=False)
           if n > max_points else np.arange(n))
    sel.sort()
    modes: Dict[str, np.ndarray] = {}
    if rgb is not None:
        modes["rgb"] = np.clip(np.asarray(rgb)[sel] * 255, 0, 255).astype(np.uint8)
    if labels is not None:
        modes["labels"] = _label_colors(np.asarray(labels)[sel])
    if preds is not None:
        modes["preds"] = _label_colors(np.asarray(preds)[sel])
    if not modes:
        modes["height"] = _label_colors(
            (pos[sel, 2] * 4).astype(np.int64) % len(_PALETTE)
        )
    p = pos[sel] - pos[sel].mean(0)
    scale = float(np.abs(p).max() + 1e-6)

    panels = []
    if images is not None:
        m = mapping
        for i in range(len(images)):
            overlay = []
            if m is not None:
                vc = m.view_capacity
                pv = np.minimum(m.pix_view, vc - 1)
                ok = m.pix_valid & (m.image_id[pv] == i)
                xs = m.pix_x[ok][:4000].tolist()
                ys = m.pix_y[ok][:4000].tolist()
                overlay = [xs, ys]
            panels.append({"png": _png_b64(images[i]), "overlay": overlay,
                           "w": int(images[i].shape[0]),
                           "h": int(images[i].shape[1])})

    data = {
        "pos": np.round(p / scale, 4).tolist(),
        "modes": {k: v.tolist() for k, v in modes.items()},
        "panels": panels,
        "title": title,
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deepviewagg viewer</title>
<style>
 body{margin:0;background:#111;color:#eee;font-family:sans-serif}
 #bar{padding:6px}
 button{margin-right:6px}
 #panels img{max-height:160px;margin:4px;border:1px solid #444}
 #panels{white-space:nowrap;overflow-x:auto}
 .imgwrap{position:relative;display:inline-block}
 canvas.ov{position:absolute;left:4px;top:4px;pointer-events:none}
</style></head><body>
<div id="bar"><span id="title"></span> — color: <span id="btns"></span>
 drag = orbit, wheel = zoom</div>
<canvas id="c" width="1000" height="640" style="display:block"></canvas>
<div id="panels"></div>
<script>
const D = __DATA__;
document.getElementById('title').textContent = D.title;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let mode = Object.keys(D.modes)[0];
let rx = -1.0, rz = 0.6, zoom = 280;
const btns = document.getElementById('btns');
for (const m of Object.keys(D.modes)) {
  const b = document.createElement('button');
  b.textContent = m; b.onclick = () => { mode = m; draw(); };
  btns.appendChild(b);
}
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const cols = D.modes[mode], P = D.pos;
  const ca=Math.cos(rz), sa=Math.sin(rz), cb=Math.cos(rx), sb=Math.sin(rx);
  const cx=cv.width/2, cy=cv.height/2;
  const img = ctx.createImageData(cv.width, cv.height);
  const buf = img.data;
  for (let i=0;i<P.length;i++){
    const x=P[i][0], y=P[i][1], z=P[i][2];
    const x1 = ca*x - sa*y, y1 = sa*x + ca*y;
    const y2 = cb*y1 - sb*z, z2 = sb*y1 + cb*z;
    const px = Math.round(cx + x1*zoom), py = Math.round(cy - z2*zoom);
    if (px<0||py<0||px>=cv.width||py>=cv.height) continue;
    const o = 4*(py*cv.width+px);
    buf[o]=cols[i][0]; buf[o+1]=cols[i][1]; buf[o+2]=cols[i][2]; buf[o+3]=255;
  }
  ctx.putImageData(img, 0, 0);
}
let drag=false, lx=0, ly=0;
cv.onmousedown = e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup = ()=>drag=false;
window.onmousemove = e=>{ if(!drag) return;
  rz += (e.clientX-lx)*0.01; rx += (e.clientY-ly)*0.01;
  lx=e.clientX; ly=e.clientY; draw(); };
cv.onwheel = e=>{ zoom *= e.deltaY<0?1.1:0.9; e.preventDefault(); draw(); };
const panels = document.getElementById('panels');
for (const p of D.panels){
  const wrap = document.createElement('div'); wrap.className='imgwrap';
  const im = document.createElement('img');
  im.src = 'data:image/png;base64,'+p.png;
  wrap.appendChild(im);
  if (p.overlay.length){
    const oc = document.createElement('canvas'); oc.className='ov';
    im.onload = ()=>{
      oc.width = im.width; oc.height = im.height;
      const g = oc.getContext('2d'); g.fillStyle='rgba(255,60,60,0.6)';
      const sx = im.width/p.w, sy = im.height/p.h;
      const [xs, ys] = p.overlay;
      for (let i=0;i<xs.length;i++) g.fillRect(xs[i]*sx, ys[i]*sy, 1.5, 1.5);
    };
    wrap.appendChild(oc);
  }
  panels.appendChild(wrap);
}
draw();
</script></body></html>
"""
