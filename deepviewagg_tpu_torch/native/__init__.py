"""Native host builders: voxel hashing, kernel maps and grid kNN (C++).

The port of ``deepviewagg_tpu/native``: ``kernelmap.cpp`` (the same
algorithms, behind a plain C ABI) is compiled with ``g++`` at first use into
``deepviewagg_tpu_torch/_build/`` by :mod:`..utils.cuda_build` and loaded
with ``ctypes``.  The functions below take and return numpy arrays with the
JAX extension's dtypes and give its bytes.  A failed build raises: there is
no numpy fallback (the numpy versions stay beside their callers as
``_plain`` functions, for the tests).

``threads``: 0 uses the host's cores (at most 16); the bytes do not depend
on it (each output row is written by one thread).
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["build_kernel_map", "unique_inverse", "query_coords", "knn_grid"]

_OUT_OF_RANGE = {1: 0, 2: 1}       # return code -> which coordinate array


def _lib():
    from ..utils import cuda_build

    return cuda_build.load("kernelmap")


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _coords(a, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"{name} must be int32 [N, 4]")
    return a


def _check(code: int, bad_row: ctypes.c_int64, arrays, names) -> None:
    """Raise for a native return code (as the JAX extension raises)."""
    if code == 0:
        return
    if code in _OUT_OF_RANGE:
        which = _OUT_OF_RANGE[code]
        i = bad_row.value
        b, x, y, z = (int(v) for v in arrays[which][i])
        raise ValueError(f"{names[which]} row {i} out of 19-bit key range "
                         f"(batch {b}, coords {x} {y} {z})")
    raise ValueError(f"native call failed with code {code}")


def build_kernel_map(in_coords, out_coords, offsets, stride: int,
                     cap_in: int = -1, cap_out: int = -1,
                     threads: int = 0) -> np.ndarray:
    """``nbr int32 [K, cap_out]``: the row of ``in_coords`` at ``out_coords[o]
    + offsets[k] * stride``, else ``pad = cap_in``; ``cap_in`` / ``cap_out``
    default to the row counts (unpadded)."""
    in_c = _coords(in_coords, "in_coords")
    out_c = _coords(out_coords, "out_coords")
    offs = np.ascontiguousarray(offsets, np.int32)
    if offs.ndim != 2 or offs.shape[1] != 3:
        raise ValueError("offsets must be int32 [K, 3]")
    n, m, k = len(in_c), len(out_c), len(offs)
    cap_in = n if cap_in < 0 else int(cap_in)
    cap_out = m if cap_out < 0 else int(cap_out)
    if cap_in < n or cap_out < m:
        raise ValueError("capacity below row count")
    nbr = np.empty((k, cap_out), np.int32)
    bad = ctypes.c_int64(-1)
    code = _lib().dva_build_kernel_map(
        _ptr(in_c), n, _ptr(out_c), m, _ptr(offs), k, int(stride), cap_in,
        cap_out, _ptr(nbr), int(threads), ctypes.byref(bad))
    _check(code, bad, (in_c, out_c), ("in_coords", "out_coords"))
    return nbr


def unique_inverse(coords):
    """``(unique int32 [M, 4] in ascending key order, each the first
    occurrence of its key, inverse int32 [N])``."""
    c = _coords(coords, "coords")
    n = len(c)
    uniq = np.empty((n, 4), np.int32)
    inverse = np.empty(n, np.int32)
    m, bad = ctypes.c_int64(0), ctypes.c_int64(-1)
    code = _lib().dva_unique_inverse(_ptr(c), n, _ptr(uniq), _ptr(inverse),
                                     ctypes.byref(m), ctypes.byref(bad))
    _check(code, bad, (c,), ("coords",))
    return uniq[:m.value].copy(), inverse


def query_coords(table, queries) -> np.ndarray:
    """``int32 [M]``: the row of ``table`` (unique rows) equal to each query,
    or -1."""
    tab = _coords(table, "table")
    q = _coords(queries, "queries")
    out = np.empty(len(q), np.int32)
    bad = ctypes.c_int64(-1)
    code = _lib().dva_query_coords(_ptr(tab), len(tab), _ptr(q), len(q),
                                   _ptr(out), ctypes.byref(bad))
    _check(code, bad, (tab, q), ("table", "queries"))
    return out


def knn_grid(points, queries, k: int, cell: float, threads: int = 0):
    """``(d2 float32 [M, k] ascending, idx int32 [M, k])``: the exact ``k``
    nearest of ``points`` to each query over cubic cells of edge ``cell``,
    searched over at most 16 rings of cells around the query's; a shorter
    neighbourhood repeats its nearest hit."""
    p = np.ascontiguousarray(points, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    if (p.ndim != 2 or p.shape[1] != 3 or q.ndim != 2 or q.shape[1] != 3
            or k < 1 or not cell > 0):
        raise ValueError("knn_grid(points f32 [N,3], queries f32 [M,3], "
                         "k>=1, cell>0)")
    if len(p) == 0:
        raise ValueError("knn_grid: empty points")
    d2 = np.empty((len(q), k), np.float32)
    idx = np.empty((len(q), k), np.int32)
    code = _lib().dva_knn_grid(_ptr(p), len(p), _ptr(q), len(q), int(k),
                               float(cell), _ptr(d2), _ptr(idx), int(threads))
    _check(code, None, (), ())
    if len(q) and idx[:, 0].min() < 0:
        i = int(np.argmin(idx[:, 0]))
        raise ValueError(f"knn_grid: query {i} has no point within 16 cells "
                         f"of edge {cell}")
    return d2, idx
