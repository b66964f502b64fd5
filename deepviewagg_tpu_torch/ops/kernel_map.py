"""Host-side kernel-map construction for sparse 3D convolution.

The TPU sparse conv is *gather-GEMM* over precomputed neighbor tables
(SURVEY.md §7 design move 3; the role torchsparse's ``sphash``/``sphashquery``
CUDA kernels play in the reference, modules/SparseConv3d/nn/torchsparse.py).

Key structural fact exploited here: voxel coordinates are unique, so for any
kernel offset ``k`` each output voxel has **at most one** input neighbor at
``out_coord + offset_k * stride``.  The kernel map is therefore a dense
``int32 [K, n_out]`` neighbor table (pad value = ``n_in`` -> zero dump row),
and the convolution is K gathers + one batched matmul — an im2col that needs
**no scatter**, unlike pair-list formulations.  On TPU this turns the conv
into a single MXU-shaped ``[n_out, K*Cin] @ [K*Cin, Cout]`` product.

Built on the host at collate time by the native builder
(``deepviewagg_tpu_torch/native``, as the JAX package does where its
extension is built; the numpy version stays as ``build_kernel_map_plain``
for the tests), padded to static shapes, shipped to the device once per
batch.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .. import native as _native
from . import voxel as _voxel

__all__ = ["KernelMap", "build_kernel_map", "kernel_offsets", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kernel_offsets(kernel_size: int, ndim: int = 3) -> np.ndarray:
    """Offsets of a cubic kernel, centered for odd sizes, positive-corner
    anchored for even sizes (torchsparse convention for stride-2 ks=2)."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(0, kernel_size)
    return np.array(list(itertools.product(r, repeat=ndim)), np.int32)


@dataclasses.dataclass
class KernelMap:
    """Dense neighbor table: ``nbr[k, o]`` = input index feeding output ``o``
    through kernel offset ``k`` (or ``n_in`` when none)."""

    nbr: np.ndarray        # int32 [K, n_out], pad = n_in
    n_in: int
    n_out: int
    kernel_size: int
    stride: int = 1

    @property
    def num_offsets(self) -> int:
        return self.nbr.shape[0]

    def transpose(self) -> "KernelMap":
        """The map of the transposed (up) convolution.

        Inverts each offset's partial injection: if input ``i`` feeds output
        ``o`` through offset ``k``, then in the transposed conv output ``i``
        is fed by input ``o`` through offset ``k``.  Each (k, i) pair occurs
        at most once because coordinates are unique, so the inverse is again
        a dense table.  (The reference recovers these correspondences from
        torchsparse's cached coords maps in its UNet up path.)
        """
        k, n_out = self.nbr.shape
        inv = np.full((k, self.n_in), n_out, np.int32)
        for kk in range(k):
            src = self.nbr[kk]
            ok = src < self.n_in
            inv[kk, src[ok]] = np.nonzero(ok)[0].astype(np.int32)
        return KernelMap(
            nbr=inv, n_in=self.n_out, n_out=self.n_in,
            kernel_size=self.kernel_size, stride=self.stride,
        )


def build_kernel_map(
    in_coords: np.ndarray,
    out_coords: np.ndarray,
    kernel_size: int = 3,
    stride: int = 1,
) -> KernelMap:
    """Build the neighbor table between two voxel coordinate sets.

    ``in_coords``/``out_coords`` are int32 [N,4] rows (batch, x, y, z) in
    level-0 units; ``stride`` is the *input* tensor stride (offsets are
    scaled by it).  For a submanifold conv, pass the same array twice.
    """
    nbr = _native.build_kernel_map(in_coords, out_coords,
                                   kernel_offsets(kernel_size), int(stride))
    return KernelMap(nbr=nbr, n_in=len(in_coords), n_out=len(out_coords),
                     kernel_size=kernel_size, stride=stride)


def build_kernel_map_plain(
    in_coords: np.ndarray,
    out_coords: np.ndarray,
    kernel_size: int = 3,
    stride: int = 1,
) -> KernelMap:
    """:func:`build_kernel_map` in numpy: one sorted-key query per offset."""
    offsets = kernel_offsets(kernel_size)
    n_in, n_out = len(in_coords), len(out_coords)
    nbr = np.full((len(offsets), n_out), n_in, np.int32)
    for k, off in enumerate(offsets):
        query = out_coords.copy()
        query[:, 1:] = query[:, 1:] + off * stride
        hit = _voxel.query_coords_plain(in_coords, query)  # idx | -1
        nbr[k] = np.where(hit >= 0, hit, n_in)
    return KernelMap(
        nbr=nbr, n_in=n_in, n_out=n_out, kernel_size=kernel_size, stride=stride
    )
