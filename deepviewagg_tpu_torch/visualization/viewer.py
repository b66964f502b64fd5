"""Per-epoch sample dumps.

The port of ``deepviewagg_tpu/visualization/viewer.py::save_ply_snapshot``
(the reference's ``Visualizer`` writes selected samples as .ply per epoch,
visualization/visualizer.py:10), numpy over the port's PLY writer: the same
arrays give the same bytes.  The JAX module's standalone HTML viewer
(``export_html``) is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.ply import write_ply

__all__ = ["save_ply_snapshot"]


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
