"""Voxel levels and convolution pairs, worked out from level-0 coordinates.

The plain counterpart of the port's collate-time graph: each coarser level
holds the unique voxels of the level below with their coordinates floored
to a multiple of twice its stride (in level-0 units), and each sparse
convolution is a list of ``(input row, output row)`` pairs per kernel
offset, found by a sorted-key lookup.  Offsets run in ``itertools.product``
order: ``(-1, 0, 1)^3`` for the 3 x 3 x 3 submanifold convolutions and
``(0, 1)^3`` for the 2 x 2 x 2 strided ones.  Imports nothing of the port.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import torch

__all__ = ["Graph", "build_graph", "SUB_OFFSETS", "DOWN_OFFSETS"]

SUB_OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))
DOWN_OFFSETS = list(itertools.product((0, 1), repeat=3))

# key layout: 4 bits of sample, 19 bits per axis (offset by 2^18)
_AXIS_BITS = 19
_AXIS_OFFSET = 1 << (_AXIS_BITS - 1)


def _keys(c: torch.Tensor) -> torch.Tensor:
    """int64 keys of ``[n, 4]`` (sample, x, y, z) rows."""
    if c.shape[0] and (int(c[:, 0].max()) >= 16
                       or int(c[:, 1:].abs().max()) >= _AXIS_OFFSET - 4):
        raise ValueError("coordinates out of the key range")
    k = c[:, 0].to(torch.int64)
    for a in range(1, 4):
        k = (k << _AXIS_BITS) | (c[:, a].to(torch.int64) + _AXIS_OFFSET)
    return k


class _Lookup:
    """Row of each query coordinate among ``coords``, -1 where absent."""

    def __init__(self, coords: torch.Tensor):
        keys = _keys(coords)
        self.sorted, self.order = torch.sort(keys)

    def __call__(self, query: torch.Tensor) -> torch.Tensor:
        q = _keys(query)
        pos = torch.searchsorted(self.sorted, q).clamp(
            max=max(self.sorted.numel() - 1, 0))
        if self.sorted.numel() == 0:
            return torch.full_like(q, -1)
        hit = self.sorted[pos] == q
        return torch.where(hit, self.order[pos], torch.full_like(q, -1))


Pairs = List[Tuple[torch.Tensor, torch.Tensor]]


class Graph:
    """``coords[l]`` (int64 ``[n_l, 4]``, level-0 units), ``sub[l]`` (the
    submanifold pairs at level ``l``, one ``(in, out)`` pair of index
    tensors per offset) and ``down[l]`` (level ``l`` -> ``l + 1``: the
    strided pairs, ``in`` at level ``l``, ``out`` at level ``l + 1``; the
    transposed convolution uses them with the roles swapped)."""

    def __init__(self, coords, sub, down):
        self.coords = coords
        self.sub = sub
        self.down = down

    def pair_counts(self):
        """``(sub pairs per level, down pairs per level)``."""
        return ([sum(int(i.numel()) for i, _ in p) for p in self.sub],
                [sum(int(i.numel()) for i, _ in p) for p in self.down])


def build_graph(coords0: torch.Tensor, num_levels: int) -> Graph:
    """The levels and pairs of level-0 voxels ``coords0 [n, 4]`` (sample,
    x, y, z; unique rows)."""
    coords = [coords0.to(torch.int64)]
    for lvl in range(num_levels - 1):
        step = 2 ** (lvl + 1)
        c = coords[-1].clone()
        c[:, 1:] = torch.div(c[:, 1:], step, rounding_mode="floor") * step
        coords.append(torch.unique(c, dim=0))
    sub, down = [], []
    for lvl, c in enumerate(coords):
        stride = 2 ** lvl
        look = _Lookup(c)
        rows = torch.arange(c.shape[0], device=c.device)
        pairs = []
        for off in SUB_OFFSETS:
            q = c.clone()
            q[:, 1:] += torch.tensor(off, device=c.device) * stride
            idx = look(q)
            hit = idx >= 0
            pairs.append((idx[hit], rows[hit]))
        sub.append(pairs)
        if lvl + 1 < len(coords):
            nxt = coords[lvl + 1]
            nrows = torch.arange(nxt.shape[0], device=c.device)
            pairs = []
            for off in DOWN_OFFSETS:
                q = nxt.clone()
                q[:, 1:] += torch.tensor(off, device=c.device) * stride
                idx = look(q)
                hit = idx >= 0
                pairs.append((idx[hit], nrows[hit]))
            down.append(pairs)
    return Graph(coords, sub, down)
