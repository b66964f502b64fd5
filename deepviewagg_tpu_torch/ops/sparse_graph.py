"""Host-side construction of the full multi-level sparse-UNet "graph".

At collate time we precompute, for a voxelized batch, everything the device
needs to run a Res16UNet-style encoder/decoder without any coordinate math:
per-level voxel coordinates, validity masks, submanifold kernel maps, strided
down-conv maps, their transposes for up-convs, and the level-to-level parent
('merge') indices used to carry point->image mappings across strides
(reference ``forward_3d_block_down``, modules/multimodal/modules.py:101-236).

Shapes are static per (capacities, kernel caps) bucket.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import native as _native
from . import kernel_map as _km
from . import voxel as _voxel

__all__ = [
    "LevelArrays",
    "SparseGraphArrays",
    "build_unet_graph",
    "graph_to_device",
    "build_ptv3_graph",
]


@dataclasses.dataclass
class LevelArrays:
    """Numpy arrays for one resolution level (host side)."""

    coords: np.ndarray            # int32 [cap, 4] padded
    valid: np.ndarray             # bool [cap]
    batch_idx: np.ndarray         # int32 [cap] (pad -> num_batches slot)
    num_valid: int
    sub_map: _km.KernelMap        # submanifold conv map at this level
    down_map: Optional[_km.KernelMap]  # to next level (None on last)
    parent: Optional[np.ndarray]  # int32 [cap] -> next-level index (pad cap_next)


@dataclasses.dataclass
class SparseGraphArrays:
    levels: List[LevelArrays]
    conv0_map: _km.KernelMap      # initial conv (possibly ks=5) at level 0

    @property
    def num_levels(self):
        return len(self.levels)


def _pad_coords(coords, cap, num_batches):
    n = len(coords)
    out = np.zeros((cap, 4), np.int32)
    out[:n] = coords[:cap]
    # Padding voxels go to a far-away corner of an extra batch slot so they
    # never alias real voxels in any kernel-map query.
    out[n:, 0] = num_batches
    out[n:, 1:] = -(1 << 19)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out, valid


def build_unet_graph(
    coords: np.ndarray,
    num_levels: int,
    num_batches: int,
    conv0_kernel: int = 5,
    sub_kernel: int = 3,
    capacities: Optional[Sequence[int]] = None,
    cap_multiple: int = 512,
) -> SparseGraphArrays:
    """Build all levels from level-0 voxel coords ``int32 [N, 4]``.

    ``capacities`` optionally fixes per-level static sizes (bucketing);
    otherwise each level's capacity is its count rounded up to
    ``cap_multiple``.  Kernel maps are dense [K, cap_out] neighbor tables.
    """
    levels = []
    cur = np.asarray(coords, np.int32)
    stride = 1
    conv0_map = None

    for lvl in range(num_levels):
        n = len(cur)
        cap = (
            capacities[lvl]
            if capacities is not None
            else max(_km.round_up(n, cap_multiple), cap_multiple)
        )
        if n > cap:
            raise ValueError(
                f"level {lvl}: {n} voxels exceed capacity {cap}; "
                f"increase bucket or subsample"
            )
        padded, valid = _pad_coords(cur, cap, num_batches)

        if lvl == 0 and conv0_kernel != sub_kernel:
            conv0_map = _build_padded_map(
                cur, cur, conv0_kernel, stride, cap, cap
            )
        sub = _build_padded_map(cur, cur, sub_kernel, stride, cap, cap)
        if lvl == 0 and conv0_map is None:
            conv0_map = sub

        down_map = None
        parent_padded = None
        if lvl < num_levels - 1:
            nxt, parent = _voxel.downsample_coords(cur, stride * 2)
            cap_next = (
                capacities[lvl + 1]
                if capacities is not None
                else max(_km.round_up(len(nxt), cap_multiple), cap_multiple)
            )
            if len(nxt) > cap_next:
                # before the down map is padded to it
                raise ValueError(
                    f"level {lvl + 1}: {len(nxt)} voxels exceed capacity "
                    f"{cap_next}; increase bucket or subsample"
                )
            down_map = _build_padded_map(
                cur, nxt, 2, stride, cap, cap_next
            )
            parent_padded = np.full(cap, cap_next, np.int32)
            parent_padded[:n] = parent
            cur = nxt
            stride *= 2

        levels.append(
            LevelArrays(
                coords=padded,
                valid=valid,
                batch_idx=np.where(valid, padded[:, 0], num_batches).astype(np.int32),
                num_valid=n,
                sub_map=sub,
                down_map=down_map,
                parent=parent_padded,
            )
        )
    return SparseGraphArrays(levels=levels, conv0_map=conv0_map)


def graph_to_device(graph: SparseGraphArrays) -> dict:
    """Flatten a host graph into the plain-array pytree the models consume.

    Per level: ``valid bool [cap]``, ``batch_idx int32 [cap]``, ``sub_nbr
    int32 [K, cap]``; non-last levels add ``down_nbr [K2, cap_next]``,
    ``up_nbr [K2, cap]`` (the transposed down map feeding the decoder's
    up-conv) and ``parent int32 [cap]`` (the 'merge' reindex for carrying
    point->image mappings across strides).  Everything stays numpy —
    :func:`deepviewagg_tpu_torch.data.collate.batch_to_torch` moves it to the
    device once per batch.
    """
    levels = []
    for lvl in graph.levels:
        d = {
            "valid": lvl.valid,
            "batch_idx": lvl.batch_idx,
            "sub_nbr": lvl.sub_map.nbr,
        }
        if lvl.down_map is not None:
            d["down_nbr"] = lvl.down_map.nbr
            d["up_nbr"] = lvl.down_map.transpose().nbr
            d["parent"] = lvl.parent
        levels.append(d)
    return {"levels": levels, "conv0_nbr": graph.conv0_map.nbr}


def build_ptv3_graph(
    coords: np.ndarray,
    num_levels: int,
    num_batches: int,
    capacities: Sequence[int],
    stem_kernel: int = 5,
    sub_kernel: int = 3,
) -> dict:
    """The point pyramid of a Point Transformer V3 batch, from level-0 grid
    cells ``int32 [N, 4]`` (sample, x, y, z; non-negative, rows sorted by
    sample): the plain-array pytree its model consumes.

    Level ``l + 1`` holds the distinct parent cells ``g >> 1`` of level
    ``l`` (the serialized pooling's clusters, coordinates kept in level-0
    units), from the native voxel hash.  Per level: ``valid``,
    ``batch_idx`` (padding rows: ``num_batches``) and the submanifold map
    ``sub_nbr [sub_kernel^3, cap]`` (the xCPE's, shared by every block of
    the level); below the last level the clusters: ``pool_perm [cap]`` (the
    level's rows sorted by cluster, stable, padding rows last),
    ``pool_ptr int32 [cap_next + 2]`` (their CSR; the last segment holds
    the padding rows and is dropped), ``pool_head [cap_next]`` (each
    cluster's first row, 0 for padding clusters) and ``parent [cap]`` (each
    row's cluster, 0 for padding rows).  Besides: ``conv0_nbr`` (the stem's
    ``stem_kernel^3`` map at level 0), ``grid int32 [cap0, 3]`` (the level-0
    cells, 0 on padding rows), ``depth`` (the bit length of the largest
    coordinate) and ``counts`` (per level, the points of each sample),
    host integers.
    """
    cur = np.asarray(coords, np.int32)
    if len(cur) and cur[:, 1:].min() < 0:
        raise ValueError("PTv3 grid coordinates must be non-negative")
    levels, counts = [], []
    stride = 1
    conv0 = None
    for lvl in range(num_levels):
        n, cap = len(cur), int(capacities[lvl])
        if n > cap:
            raise ValueError(f"level {lvl}: {n} points exceed capacity "
                             f"{cap}; increase bucket or subsample")
        padded, valid = _pad_coords(cur, cap, num_batches)
        if lvl == 0:
            conv0 = _build_padded_map(cur, cur, stem_kernel, 1, cap, cap)
            grid = np.zeros((cap, 3), np.int32)
            grid[:n] = cur[:, 1:]
        d = {
            "valid": valid,
            "batch_idx": np.where(valid, padded[:, 0],
                                  num_batches).astype(np.int32),
            "sub_nbr": _build_padded_map(cur, cur, sub_kernel, stride, cap,
                                         cap).nbr,
        }
        counts.append(np.bincount(cur[:, 0], minlength=num_batches)
                      .astype(int).tolist())
        if lvl < num_levels - 1:
            nxt, parent = _voxel.downsample_coords(cur, stride * 2)
            cap_next = int(capacities[lvl + 1])
            if len(nxt) > cap_next:
                raise ValueError(
                    f"level {lvl + 1}: {len(nxt)} points exceed capacity "
                    f"{cap_next}; increase bucket or subsample")
            perm = np.argsort(parent, kind="stable").astype(np.int32)
            d["pool_perm"] = np.concatenate(
                [perm, np.arange(n, cap, dtype=np.int32)])
            ptr = np.searchsorted(parent[perm], np.arange(cap_next + 1))
            d["pool_ptr"] = np.concatenate([ptr, [cap]]).astype(np.int32)
            head = np.zeros(cap_next, np.int32)
            head[:len(nxt)] = perm[ptr[:len(nxt)]]
            d["pool_head"] = head
            d["parent"] = pad_parent = np.zeros(cap, np.int32)
            pad_parent[:n] = parent
            cur = nxt
            stride *= 2
        levels.append(d)
    depth = int(grid[:len(coords)].max(initial=0)).bit_length() or 1
    return {"levels": levels, "conv0_nbr": conv0.nbr, "grid": grid,
            "depth": depth, "counts": counts}


def _build_padded_map(in_c, out_c, ks, stride, cap_in, cap_out):
    """Kernel map padded to capacities: nbr int32 [K, cap_out], pad = cap_in,
    written by the native builder straight into the capacity."""
    nbr = _native.build_kernel_map(in_c, out_c, _km.kernel_offsets(ks),
                                   int(stride), int(cap_in), int(cap_out))
    return _km.KernelMap(
        nbr=nbr, n_in=cap_in, n_out=cap_out, kernel_size=ks, stride=stride
    )


def _build_padded_map_plain(in_c, out_c, ks, stride, cap_in, cap_out):
    """:func:`_build_padded_map` in numpy: the unpadded map, re-padded."""
    m = _km.build_kernel_map_plain(in_c, out_c, kernel_size=ks, stride=stride)
    k = m.num_offsets
    nbr = np.full((k, cap_out), cap_in, np.int32)
    nbr[:, : m.n_out] = np.where(m.nbr == m.n_in, cap_in, m.nbr)
    return _km.KernelMap(
        nbr=nbr, n_in=cap_in, n_out=cap_out, kernel_size=ks, stride=stride
    )
