"""Host-side voxelization and coordinate hashing (numpy, preprocessing-time).

Replaces the reference's ``GridSampling3D``
(torch_points3d/core/data_transform/grid_transform.py:87) and the voxel
hash/query machinery it outsources to torchsparse ``sphash``/``sphashquery``
(modules/multimodal/modules.py:194-211).  Runs on the host at data-loading /
collate time: the TPU training step only ever sees the resulting static-shape
index arrays, never does coordinate arithmetic.

Coordinates are ``int32[N, 4]`` rows ``(batch, x, y, z)``; a composite
``int64`` key gives deterministic hashing, unlike the reference's GPU
``sphashquery`` which intermittently returns -1 and falls back to CPU
(modules.py:200-211, SURVEY.md §A.10.2).  ``unique_coords`` and
``query_coords`` run the native builder (``deepviewagg_tpu_torch/native``),
as the JAX package does where its extension is built; their numpy versions
stay as ``*_plain`` for the tests.
"""

from __future__ import annotations

import numpy as np

from .. import native as _native

__all__ = [
    "ravel_coords",
    "grid_sample",
    "unique_coords",
    "query_coords",
    "downsample_coords",
]

# Spatial extent bound per axis for key packing: 19 bits per axis
# (|coord| < 2^18 = 262144 voxels) leaves 6 bits for the batch dimension
# (64 samples) inside a single signed int64.
_SHIFT = 19
_BIAS = 1 << (_SHIFT - 1)
MAX_COORD = _BIAS - 1
MAX_BATCH = 1 << (63 - 3 * _SHIFT)


def ravel_coords(coords: np.ndarray) -> np.ndarray:
    """Pack (batch, x, y, z) int rows into sortable int64 keys."""
    c = coords.astype(np.int64)
    if c.size:
        assert c[:, 0].min() >= 0 and c[:, 0].max() < MAX_BATCH, "batch out of key range"
        assert abs(c[:, 1:]).max() <= MAX_COORD, "voxel coordinate out of key range"
    key = c[:, 0]
    for i in range(1, 4):
        key = (key << _SHIFT) | (c[:, i] + _BIAS)
    return key


def unique_coords(coords: np.ndarray):
    """Deduplicate coordinate rows (the native hash builder).

    Returns ``(unique_coords int32 [M,4], inverse int32 [N])`` with
    ``coords[i] == unique_coords[inverse[i]]``.  Unique rows come out in
    sorted key order, each the first occurrence of its key — deterministic
    across runs, and the same as :func:`unique_coords_plain`'s.  A row out of
    the 19-bit key range raises ``ValueError``.
    """
    return _native.unique_inverse(coords)


def unique_coords_plain(coords: np.ndarray):
    """:func:`unique_coords` in numpy (a stable sort of the packed keys)."""
    key = ravel_coords(coords)
    uniq_key, inverse = np.unique(key, return_inverse=True)
    # Recover a representative row per unique key.
    order = np.argsort(key, kind="stable")
    first = np.searchsorted(uniq_key, key[order])
    rep = np.empty(len(uniq_key), np.int64)
    rep[first[::-1]] = order[::-1]  # first occurrence wins
    return coords[rep], inverse.astype(np.int32)


def query_coords(table_coords: np.ndarray, query: np.ndarray) -> np.ndarray:
    """For each query row, the index of the matching row in ``table_coords``
    (or -1), by the native hash table.  Table rows must be unique."""
    return _native.query_coords(table_coords, query)


def query_coords_plain(table_coords: np.ndarray,
                       query: np.ndarray) -> np.ndarray:
    """:func:`query_coords` in numpy (``searchsorted`` over sorted keys)."""
    table_key = ravel_coords(table_coords)
    order = np.argsort(table_key)
    sorted_key = table_key[order]
    qkey = ravel_coords(query)
    pos = np.searchsorted(sorted_key, qkey)
    pos = np.clip(pos, 0, len(sorted_key) - 1)
    hit = sorted_key[pos] == qkey
    out = np.where(hit, order[pos], -1).astype(np.int32)
    return out


def grid_sample(pos: np.ndarray, voxel_size: float, feats=None, labels=None,
                batch=None, mode: str = "mean", origin=None,
                rounding: str = "round"):
    """Voxel-grid downsample a point cloud (GridSampling3D semantics).

    ``mode='mean'`` averages features per voxel; ``mode='last'`` keeps one
    representative point.  Labels are reduced by majority vote (the reference
    uses mode='last'/'mean' with label histograms — grid_transform.py:87-165).

    ``rounding='round'`` (default) reproduces the reference's absolute
    ``torch.round(pos / size)`` grid (grid_transform.py:131) exactly — same
    cell assignment, possibly negative coords (the int64 key packing is
    sign-safe, ±2^18 per axis; parity test
    tests/test_reference_grid_parity.py).  ``rounding='floor'`` anchors
    cells at the cloud min instead (non-negative coords).

    Returns a dict with ``coords [M,4] int32``, ``pos [M,3]`` (voxel means),
    ``feats``, ``labels``, ``inverse [N] int32`` (point -> voxel).
    """
    pos = np.asarray(pos)
    n = pos.shape[0]
    if batch is None:
        batch = np.zeros(n, np.int32)
    if rounding == "round":
        grid = np.round(pos / voxel_size).astype(np.int32)
    else:
        if origin is None:
            origin = pos.min(axis=0)
        grid = np.floor((pos - origin) / voxel_size).astype(np.int32)
    coords = np.concatenate([batch.reshape(-1, 1).astype(np.int32), grid], axis=1)
    ucoords, inverse = unique_coords(coords)
    m = len(ucoords)

    def _mean(x):
        x = np.asarray(x, np.float64)
        acc = np.zeros((m,) + x.shape[1:], np.float64)
        np.add.at(acc, inverse, x)
        cnt = np.bincount(inverse, minlength=m).reshape((m,) + (1,) * (x.ndim - 1))
        return (acc / np.maximum(cnt, 1)).astype(np.float32)

    def _last(x):
        out = np.empty((m,) + x.shape[1:], x.dtype)
        out[inverse] = x
        return out

    out = {"coords": ucoords, "inverse": inverse}
    out["pos"] = _mean(pos) if mode == "mean" else _last(pos)
    if feats is not None:
        out["feats"] = _mean(feats) if mode == "mean" else _last(np.asarray(feats))
    if labels is not None:
        labels = np.asarray(labels)
        # majority vote per voxel (ignore negative ignore-labels in the vote
        # unless a voxel only has those)
        num_classes = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 1
        hist = np.zeros((m, num_classes + 1), np.int32)
        clipped = np.where(labels >= 0, labels, num_classes)
        np.add.at(hist, (inverse, clipped), 1)
        maj = hist[:, :num_classes].argmax(axis=1)
        only_ignored = hist[:, :num_classes].sum(axis=1) == 0
        out["labels"] = np.where(only_ignored, -1, maj).astype(labels.dtype)
    return out


def downsample_coords(coords: np.ndarray, stride: int = 2):
    """Stride the coordinate grid (next UNet level).

    Returns ``(coords_out [M,4], parent [N] int32)`` where ``parent[i]`` is
    the index of the output voxel containing input voxel ``i`` — this is the
    'merge' reindex used to carry image mappings across strided convs
    (reference ``forward_3d_block_down`` modules.py:101-236 +
    ``ImageMapping.select_points`` image.py:2167).
    """
    c = coords.copy()
    c[:, 1:] = np.floor_divide(c[:, 1:], stride)
    out, parent = unique_coords(c)
    out[:, 1:] *= stride  # keep coordinates in level-0 units, torchsparse-style
    return out, parent
