"""Gathering 2D feature-map values at mapped pixels.

The port of ``deepviewagg_tpu/modules/gather.py`` (the reference's
``get_mapped_features``, core/multimodal/image.py:1262) with its modes:
  * nearest: integer-index the feature map at the (downscaled) pixel;
  * bilinear ``sparse_interpolation`` (image.py:105-170): border-clamped
    4-tap sampling at ``x / (W - 1) * Wf - 0.5`` — either as four row
    gathers (``_bilinear``) or, when the mapping is dense enough, as one
    dense separable upsample (two resize matmuls) plus one row gather
    (``_bilinear_upsampled``), chosen by the same ``_use_upsample`` rule;
  * at scale 1 the gather indexes exactly, even with interpolation on
    (image.py:1278-1284).

All taps index a flattened ``[I*Wf*Hf, C]`` view of ``[I, Wf, Hf, C]`` maps.
These gathers stay plain PyTorch in this version of the port; every row
gather is an ``index_select`` (``_rows``), so that autograd's scatter-add of
the cotangent rows is an atomic ``index_add_`` and not the sort of
``index_put_(accumulate=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_pixel_features"]

_UPSAMPLE_MAX_BYTES = int(1.6e9)


def _resize_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """[n_out, n_in] bilinear resize rows under the reference's
    ``sparse_interpolation`` convention (image.py:142-146):
    ``xf = x / (n_out - 1) * n_in - 0.5`` with border (replication) padding
    — clamped taps keep their unclamped weights, so rows still sum to 1."""
    xf = np.arange(n_out, dtype=np.float64) / max(n_out - 1, 1) * n_in - 0.5
    x0 = np.floor(xf)
    t = (xf - x0).astype(np.float32)
    x0 = x0.astype(np.int64)
    rows = np.arange(n_out)
    mat = np.zeros((n_out, n_in), np.float32)
    np.add.at(mat, (rows, np.clip(x0, 0, n_in - 1)), 1.0 - t)
    np.add.at(mat, (rows, np.clip(x0 + 1, 0, n_in - 1)), t)
    return torch.as_tensor(mat, device=device)


def _rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for an int64 row index, as ``index_select``: on CUDA its
    backward adds the cotangent rows with atomics (the order of the float
    additions into one row is then not fixed), where advanced indexing
    differentiates through ``index_put_(accumulate=True)``, which sorts the
    index first and takes tens of times longer at a million rows."""
    return flat.index_select(0, idx)


def _use_upsample(i_cap, w, h, c, n_rows, itemsize) -> bool:
    up_bytes = i_cap * w * h * c * itemsize
    if up_bytes > _UPSAMPLE_MAX_BYTES:
        return False
    # 3 saved gather rows per mapping row vs one dense [I*W*H, C] write +
    # matmul: worth it once rows are ~1/8 of up pixels
    return 3 * n_rows >= (i_cap * w * h) // 8


def _bilinear_upsampled(maps, img_id, xi, yi, w, h, valid=None):
    """Exact replacement for ``_bilinear`` at integer ref-resolution pixel
    coords: dense separable upsample (two matmuls) + one row gather."""
    _, wf, hf, c = maps.shape
    up = torch.einsum("aw,iwhc->iahc", _resize_matrix(w, wf, maps.device), maps)
    up = torch.einsum("bh,iahc->iabc", _resize_matrix(h, hf, maps.device), up)
    flat = up.reshape(-1, c)
    idx = (img_id.to(torch.int64) * (w * h)
           + torch.clamp(xi, 0, w - 1).to(torch.int64) * h
           + torch.clamp(yi, 0, h - 1))
    out = _rows(flat, idx)
    if valid is not None:
        out = out * valid[:, None].to(out.dtype)
    return out


def _bilinear(maps, img_id, xf, yf):
    """maps [I, W, H, C]; xf/yf float pixel coords in map units; border
    (replication) padding, weights in the map dtype."""
    _, w, h, _ = maps.shape
    flat = maps.reshape(-1, maps.shape[-1])
    base = img_id.to(torch.int64) * (w * h)
    x0 = torch.floor(xf).to(torch.int64)
    y0 = torch.floor(yf).to(torch.int64)
    tx = (xf - x0)[:, None].to(maps.dtype)
    ty = (yf - y0)[:, None].to(maps.dtype)

    def tap(xi, yi):
        return _rows(flat, base + torch.clamp(xi, 0, w - 1) * h
                     + torch.clamp(yi, 0, h - 1))

    return (
        tap(x0, y0) * (1 - tx) * (1 - ty)
        + tap(x0 + 1, y0) * tx * (1 - ty)
        + tap(x0, y0 + 1) * (1 - tx) * ty
        + tap(x0 + 1, y0 + 1) * tx * ty
    )


def gather_pixel_features(feature_maps: torch.Tensor, mapping: dict, ref_size,
                          interpolate: bool = True) -> torch.Tensor:
    """Per-mapped-pixel features ``[Qc, C]`` (invalid rows -> 0) from
    ``feature_maps [I, Wf, Hf, C]``; pixel coords live at ``ref_size``
    ``(W, H)`` resolution."""
    i_cap, wf, hf, _ = feature_maps.shape
    w, h = ref_size
    vc = mapping["view_valid"].shape[0]
    pv = torch.clamp(mapping["pix_view"], max=vc - 1)
    img_id = torch.clamp(mapping["image_id"][pv], 0, i_cap - 1)
    if interpolate and (wf, hf) == (w, h):
        interpolate = False
    if interpolate:
        px, py = mapping["pix_x"], mapping["pix_y"]
        if _use_upsample(i_cap, w, h, feature_maps.shape[-1], px.shape[0],
                         feature_maps.element_size()):
            return _bilinear_upsampled(
                feature_maps, img_id, px.to(torch.int64), py.to(torch.int64),
                w, h, valid=mapping["pix_valid"])
        xf = px.to(torch.float32) / max(w - 1, 1) * wf - 0.5
        yf = py.to(torch.float32) / max(h - 1, 1) * hf - 0.5
        out = _bilinear(feature_maps, img_id, xf, yf)
    else:
        xi = torch.clamp((mapping["pix_x"].to(torch.float32) * (wf / w))
                         .to(torch.int64), 0, wf - 1)
        yi = torch.clamp((mapping["pix_y"].to(torch.float32) * (hf / h))
                         .to(torch.int64), 0, hf - 1)
        flat = feature_maps.reshape(-1, feature_maps.shape[-1])
        out = _rows(flat, img_id.to(torch.int64) * (wf * hf) + xi * hf + yi)
    return out * mapping["pix_valid"][:, None].to(out.dtype)
