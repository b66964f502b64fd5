"""Point clouds for the tests of the per-sample kNN (``ops/knn.py``,
``csrc/knn.cu``): samples of uneven sizes (some below ``k``, one empty),
clusters of different densities, planes, repeated points and far
outliers."""

from __future__ import annotations

import numpy as np
import torch


def cloud(seed: int, sizes, device="cpu"):
    """``(pos f32 [n, 3], offsets int32 [B + 1])``: per sample, a mix of a
    dense and a sparse Gaussian cluster, a plane at 2 cm spacing, every
    seventh point a copy of one before it, and one point 10 m away."""
    rng = np.random.default_rng(seed)
    parts = []
    for n in sizes:
        n_dense, n_plane = n // 3, n // 4
        n_sparse = n - n_dense - n_plane
        dense = rng.normal(0, 0.05, (n_dense, 3))
        sparse = rng.normal(0, 1.0, (n_sparse, 3)) + rng.uniform(-2, 2, 3)
        side = int(np.ceil(np.sqrt(max(n_plane, 1))))
        g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
        plane = np.concatenate([g.reshape(-1, 2)[:n_plane] * 0.02,
                                np.full((n_plane, 1), 0.5)], 1)
        p = np.concatenate([dense, sparse, plane]).astype(np.float32)
        rng.shuffle(p)
        if n >= 14:
            p[7::7] = p[3:len(p[7::7]) + 3]
            p[-1] = p[-1] + np.float32(10.0)
        parts.append(p)
    pos = np.concatenate(parts) if parts else np.zeros((0, 3), np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(off).to(device))


def brute(pos, offsets, k: int, rows=None):
    """The brute force in numpy: per query of ``rows`` (all by default),
    float32 ``dx*dx + dy*dy + dz*dz`` over its sample, sorted by (distance,
    row); ``idx [m, k]`` with -1 past the sample's size."""
    p = pos.cpu().numpy()
    off = offsets.cpu().numpy()
    rows = np.arange(len(p)) if rows is None else np.asarray(rows)
    sample = np.searchsorted(off, rows, side="right") - 1
    idx = np.full((len(rows), k), -1, np.int64)
    for i, (r, b) in enumerate(zip(rows, sample)):
        cand = np.arange(off[b], off[b + 1])
        d = p[cand] - p[r]
        dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        order = np.lexsort((cand, dist))[:k]
        idx[i, :len(order)] = cand[order]
    return idx


def cells(pos, sample, lo, h, ncell):
    """int64 ``[n, 3]`` cells (x, y, z) of the points, as the kernel's
    ``cell_of`` rounds them."""
    s = sample.to(torch.int64)
    c = torch.floor((pos - lo[s]) / h[s][:, None]).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), ncell[s].to(torch.int64) - 1)


def rings(pos, offsets, k: int, max_ring: int = 6):
    """The kernel's search (``csrc/knn.cu``) for one query at a time, in
    Python (slow): the cells of ``ops/knn.py::cell_grid``, rings of cells
    around the query's own until the ``KERNEL_K``-th best lies within the
    query's distance to the faces of the searched box less 1/512 cell, or
    the box covers the sample, the whole sample after ``max_ring`` rings;
    int32 ``[n, k]``."""
    from deepviewagg_tpu_torch.ops import knn as K

    n = pos.shape[0]
    kk = K.KERNEL_K
    sample = K._sample_ids(offsets, n)
    lo, h, ncell = K.cell_grid(pos, sample, offsets, kk)
    own = cells(pos, sample, lo, h, ncell).tolist()
    u = ((pos - lo[sample.long()]) / h[sample.long()][:, None]).tolist()
    lists = {}
    for i, (c, s) in enumerate(zip(own, sample.tolist())):
        lists.setdefault((s, *c), []).append(i)
    off = offsets.tolist()
    pts = pos.tolist()
    hs, ncs = h.tolist(), ncell.tolist()
    margin = np.float32(1.0 / 512.0)
    out = torch.full((n, k), -1, dtype=torch.int32)
    for i in range(n):
        s = int(sample[i])
        q = np.asarray(pts[i], np.float32)
        best = []

        def visit(j):
            d = np.asarray(pts[j], np.float32) - q
            dd = np.float32(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
            best.append((np.float32(dd + np.float32(d[2] * d[2])), j))

        cx, cy, cz = own[i]
        nx, ny, nz = ncs[s]
        done = False
        for r in range(max_ring + 1):
            for z in range(cz - r, cz + r + 1):
                for y in range(cy - r, cy + r + 1):
                    for x in range(cx - r, cx + r + 1):
                        if max(abs(x - cx), abs(y - cy), abs(z - cz)) != r:
                            continue
                        for j in lists.get((s, x, y, z), ()):
                            visit(j)
            best.sort()
            del best[kk:]
            gaps = []
            for c, nc, uu in zip((cx, cy, cz), (nx, ny, nz), u[i]):
                if c - r > 0:
                    gaps.append(np.float32(uu) - np.float32(c - r))
                if c + r < nc - 1:
                    gaps.append(np.float32(c + r + 1) - np.float32(uu))
            if not gaps:
                done = True
                break
            gap = np.float32(min(gaps))
            if gap > margin and len(best) == kk:
                reach = np.float32((gap - margin) * np.float32(hs[s]))
                if best[-1][0] <= np.float32(reach * reach):
                    done = True
                    break
        if not done:
            best = []
            for j in range(off[s], off[s + 1]):
                visit(j)
            best.sort()
        for slot, (_, j) in enumerate(best[:k]):
            out[i, slot] = j
    return out
