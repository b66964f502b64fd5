"""Blockwise brute-force exact k-nearest-neighbors on the request's device.

The port of ``deepviewagg_tpu/ops/knn.py``: :func:`knn`, one tiled ``topk``
over distance blocks (``|x-y|^2 = |x|^2 + |y|^2 - 2 x.y``, one matmul per
block), the role pykeops / FAISS / torch_cluster play in the reference's
preprocessing; :func:`radius_count`, the ball-query census; and
:func:`dilated_knn`, a random ``k`` of the ``k * dilation`` nearest (the
reference's DilatedKNNNeighbourFinder), drawn from a numpy ``Generator`` as
the JAX package draws it.  Exact (no ANN); neighbors at exactly equal
distance may come out in another order than the JAX package's
``lax.top_k``.  :func:`knn_grid` is the host's exact grid kNN for
preprocessing at scale (the native builder, ``deepviewagg_tpu_torch/native``).

:func:`knn_points` is the exact per-sample kNN of every point among the
points of its own sample, on the card by the hand-written kernel
``csrc/knn.cu`` (a grid of cells searched ring by ring, the cell lists
sorted on the card), on the CPU by :func:`knn_points_plain`, the brute
force; both give the same table index for index (squared distances as
``dx*dx + dy*dy + dz*dz`` in float32, ties to the lower row).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native
from ..utils import cuda_build
from ..utils import trace

__all__ = ["knn", "knn_grid", "radius_count", "dilated_knn", "knn_points",
           "knn_points_plain", "cell_grid"]

# launches of the hand-written kernel, counted where the wrapper launches it
# (two a call: the keys and the search)
LAUNCHES = {"knn": 0}

# the kernel's width of the candidate list, Point Transformer V2's widest
# table (a call's narrower table is cut from it: the search is exact, so
# the first k of the nearest KERNEL_K are the k nearest)
KERNEL_K = 16
# the device span of the kernel's search; PTv2's tables are its one caller
CORE_SPAN = "ptv2.knn.core"
# the most cells a side of a sample's grid (the kernel's margin for the
# rounding of a point's place in its cell assumes fewer than 2^12)
MAX_CELLS = 4000


def knn(query: torch.Tensor, points: torch.Tensor, k: int, valid=None,
        block: int = 1024):
    """Exact kNN: returns ``(sq_dists [Nq, k], idx int64 [Nq, k])`` on the
    inputs' device.  ``valid`` masks padding points out of the candidates
    (their distance reads 1e30 if a row has fewer than ``k`` valid ones)."""
    query = query.to(torch.float32)
    points = points.to(torch.float32)
    big = 1e30
    pts_sq = torch.sum(points * points, dim=1)
    if valid is not None:
        pts_sq = torch.where(valid, pts_sq, big)
    dists, idx = [], []
    for start in range(0, query.shape[0], block):
        q = query[start:start + block]
        d = torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ points.T) + pts_sq[None, :]
        # the expanded form goes slightly negative for near-duplicates
        d = torch.clamp(d, min=0.0)
        if valid is not None:
            d = torch.where(valid[None, :], d, big)
        dv, di = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dists.append(dv)
        idx.append(di)
    return torch.cat(dists), torch.cat(idx)


def knn_grid(query, points, k: int, cell: float = None):
    """Exact kNN on the host over native grid-cell lists: ``(d2 float32
    [Nq, k] ascending, idx int32 [Nq, k])`` as numpy, O(N * candidates)
    instead of the brute force's O(N^2) (the role of the reference's KDTree /
    FAISS in preprocessing, features.py:360).  Distances are direct
    differences, so they round otherwise than :func:`knn`'s expanded form.
    The search stops 16 rings of cells out (``native/kernelmap.cpp``): a
    neighbour beyond is missed, a short neighbourhood repeats its nearest,
    and a query with none raises.

    ``cell``: cube edge in position units; by default sized so that the
    query's first ring holds a few ``k`` candidates.  Empty ``points`` go to
    :func:`knn` on the CPU, as the JAX package's fallback does."""
    points = np.ascontiguousarray(points, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    if len(points) == 0:
        d2, idx = knn(torch.from_numpy(query), torch.from_numpy(points), k)
        return d2.numpy(), idx.to(torch.int32).numpy()
    if cell is None:
        lo, hi = points.min(0), points.max(0)
        vol = float(np.prod(np.maximum(hi - lo, 1e-3)))
        # ~k/4 points per cell -> the 27-cell first ring holds ~7k candidates
        cell = max((vol * max(k, 4) / (4.0 * len(points))) ** (1.0 / 3.0),
                   1e-4)
    return _native.knn_grid(points, query, int(k), float(cell))


def radius_count(query: torch.Tensor, points: torch.Tensor, radius: float,
                 valid=None, block: int = 1024) -> torch.Tensor:
    """Number of (valid) points within ``radius`` of each query, int64
    ``[Nq]`` on the inputs' device: the expanded squared distance, not
    clamped, against ``radius ** 2``, as the JAX package counts."""
    query = query.to(torch.float32)
    points = points.to(torch.float32)
    pts_sq = torch.sum(points * points, dim=1)
    r2 = radius * radius
    out = []
    for start in range(0, query.shape[0], block):
        q = query[start:start + block]
        d = (torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ points.T)
             + pts_sq[None, :])
        inside = d <= r2
        if valid is not None:
            inside = inside & valid[None, :]
        out.append(torch.sum(inside, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=query.device)
    return torch.cat(out)


def dilated_knn(query: torch.Tensor, points: torch.Tensor, k: int,
                dilation: int, valid=None, rng=None, block: int = 1024):
    """Dilated kNN: the ``k * dilation`` nearest neighbors, of which a random
    ``k`` per query are kept, without replacement (a cheap receptive-field
    expansion).  ``rng`` is a numpy ``Generator`` and is required when
    ``dilation > 1``: a seeded default would pick the same subset on every
    call.  The pick is ``argpartition`` of ``rng.random`` keys per row, the
    JAX package's, so one ``Generator`` state gives both packages the same
    subset.  ``dilation <= 1`` is :func:`knn`."""
    if dilation <= 1:
        return knn(query, points, k, valid=valid, block=block)
    if rng is None:
        raise ValueError(
            "dilated_knn with dilation > 1 needs an explicit numpy Generator "
            "rng: pass the dataset's or epoch's rng so that the k-of-"
            "k*dilation subsample varies across calls")
    d, i = knn(query, points, k * dilation, valid=valid, block=block)
    keys = rng.random((i.shape[0], k * dilation))
    pick = torch.from_numpy(np.argpartition(keys, k - 1, axis=1)[:, :k]).to(
        i.device)
    return torch.gather(d, 1, pick), torch.gather(i, 1, pick)


# --- per-sample exact kNN (Point Transformer V2's neighbour tables) ---------

def _check_points(pos, offsets, k):
    if pos.dtype != torch.float32 or pos.ndim != 2 or pos.shape[1] != 3:
        raise TypeError(f"knn_points takes float32 [n, 3] points, got "
                        f"{pos.dtype} {tuple(pos.shape)}")
    if offsets.dtype != torch.int32 or offsets.ndim != 1 \
            or offsets.device != pos.device:
        raise TypeError("knn_points: offsets must be int32 [B + 1] on the "
                        "points' device")
    if not 1 <= k <= KERNEL_K:
        raise ValueError(f"knn_points: k = {k} outside [1, {KERNEL_K}]")
    if pos.shape[0] >= 2 ** 31 - 1 or offsets.numel() - 1 >= 2 ** 21:
        raise ValueError("knn_points: the kernel takes fewer than 2^31 rows "
                         "and 2^21 samples")


def _sample_ids(offsets, n):
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device, dtype=torch.int32),
        counts, output_size=n)


def cell_grid(pos, sample, offsets, k):
    """``(lo f32 [B, 3], h f32 [B], ncell int32 [B, 3])``: each sample's
    minimum corner, cell edge and cells a side.  The edge gives a surface
    (the box's three face areas, the sum over its faces halved) sampled at
    the sample's count about ``k / 2`` points a cell, so that one ring of
    cells around a point's own holds its ``k`` nearest on a scan; it is at
    least the box's longest side over :data:`MAX_CELLS` (and 1e-6)."""
    b = offsets.numel() - 1
    idx = sample.to(torch.int64)[:, None].expand(-1, 3)
    lo = torch.full((b, 3), float("inf"), device=pos.device).scatter_reduce(
        0, idx, pos, "amin")
    hi = torch.full((b, 3), -float("inf"), device=pos.device).scatter_reduce(
        0, idx, pos, "amax")
    count = (offsets[1:] - offsets[:-1]).to(torch.float32)
    empty = (count == 0)[:, None]
    lo = torch.where(empty, 0.0, lo)
    hi = torch.where(empty, 0.0, hi)
    ext = hi - lo
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])
    h = torch.sqrt(area * float(k) / (2.0 * torch.clamp(count, min=1.0)))
    h = torch.maximum(h, ext.amax(1) / MAX_CELLS)
    h = torch.clamp(h, min=1e-6)
    ncell = (torch.floor(ext / h[:, None]) + 1).to(torch.int32)
    return lo, h, ncell


def _sq_dist(p, q):
    """``dx*dx + dy*dy + dz*dz`` of ``d = p - q``, each step rounded to
    float32 (``p [..., 3]`` against ``q`` broadcast)."""
    d = p - q
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def knn_points_plain(pos, offsets, k: int, chunk: int = 2048):
    """The brute force of :func:`knn_points`: per sample and chunk of
    queries, every squared distance, the ``k`` smallest by (distance, row)
    (one ``topk`` over the distance's bits above the row's)."""
    _check_points(pos, offsets, k)
    n = pos.shape[0]
    idx = torch.full((n, k), -1, dtype=torch.int32, device=pos.device)
    off = offsets.tolist()
    for a, b in zip(off[:-1], off[1:]):
        if b <= a:
            continue
        pts = pos[a:b]
        rows = torch.arange(a, b, device=pos.device, dtype=torch.int64)
        kk = min(k, b - a)
        for s in range(a, b, chunk):
            q = pos[s:min(s + chunk, b)]
            d = _sq_dist(pts[None, :, :], q[:, None, :])
            key = (d.view(torch.int32).to(torch.int64) << 32) | rows[None, :]
            top = torch.topk(key, kk, dim=1, largest=False, sorted=True)[0]
            idx[s:s + len(q), :kk] = (top & 0xFFFFFFFF).to(torch.int32)
    return idx


def knn_points(pos, offsets, k: int, sample=None):
    """Exact kNN of every row of ``pos`` (float32 ``[n, 3]``) among the rows
    of its own sample (sample ``b``: rows ``offsets[b]`` to ``offsets[b +
    1]``, int32 ``[B + 1]``, ``offsets[-1] == n``): int32 ``[n, k]``, nearest
    first, ties to the lower row, -1 past a sample's size.  ``sample``: each
    row's sample (int32 ``[n]``), where the caller has it.  CUDA tensors
    launch ``csrc/knn.cu`` (counted in ``LAUNCHES``); CPU tensors take
    :func:`knn_points_plain`.  Traced, the kernel's search is the span
    :data:`CORE_SPAN`."""
    _check_points(pos, offsets, k)
    if pos.device.type == "cpu":
        return knn_points_plain(pos, offsets, k)
    if pos.device.type != "cuda":
        raise RuntimeError(f"knn_points: unsupported device {pos.device}")
    n = pos.shape[0]
    pos = pos.contiguous()
    offsets = offsets.contiguous()
    sample = (_sample_ids(offsets, n) if sample is None
              else sample.to(torch.int32).contiguous())
    lo, h, ncell = cell_grid(pos, sample, offsets, KERNEL_K)
    keys = torch.empty(n, dtype=torch.int64, device=pos.device)
    cuda_build.launch("knn", "knn_keys_f32", pos.device, (
        pos.data_ptr(), sample.data_ptr(), lo.data_ptr(), h.data_ptr(),
        ncell.data_ptr(), keys.data_ptr(), n), LAUNCHES)
    skey, perm = torch.sort(keys)
    perm = perm.to(torch.int32)
    spos = pos[perm]
    idx = torch.empty((n, KERNEL_K), dtype=torch.int32, device=pos.device)
    with trace.span(CORE_SPAN, device=pos):
        cuda_build.launch("knn", "knn_search_f32", pos.device, (
            spos.data_ptr(), skey.data_ptr(), perm.data_ptr(),
            offsets.data_ptr(), lo.data_ptr(), h.data_ptr(),
            ncell.data_ptr(), idx.data_ptr(), n), LAUNCHES)
    return idx if k == KERNEL_K else idx[:, :k].contiguous()
