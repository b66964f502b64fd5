"""The Lovász-softmax's gradient scan and dot product over a class-major sort.

:func:`lovasz_dot` takes each class's errors sorted in descending order,
``err_s [C, N]`` float32, and its foreground in the same order, ``fg_s [C,
N]`` uint8 (0 / 1), and returns the per-class dot products ``loss [C]`` of
the errors with the gradient of the Lovász extension of the Jaccard loss
along the sorted order (``w``, :func:`lovasz_scan`), differentiable in
``err_s``: the cotangent of ``err_s`` is ``g[c] * w[c, i]``, with no scan.

On a CUDA tensor :func:`lovasz_scan` launches the hand-written kernel
``csrc/lovasz.cu`` (counted in ``LAUNCHES``) or raises; on a CPU tensor it
runs :func:`lovasz_scan_plain`: :func:`lovasz_grad`, the plain formula,
along the last dimension.  The kernel cuts each class's rows into tiles of
:data:`TILE_ROWS` and joins them from per-tile counts;
:func:`lovasz_scan_tiled_plain` is that scheme in plain PyTorch (for tests
only: nothing on the main path calls it).
"""

from __future__ import annotations

import functools

import torch

from ..utils import cuda_build

__all__ = ["LAUNCHES", "TILE_ROWS", "lovasz_grad", "lovasz_scan",
           "lovasz_scan_plain", "lovasz_scan_tiled_plain", "lovasz_dot"]

# launches of the hand-written kernel, counted where the wrapper launches it
# (one a call: the entry point's three passes)
LAUNCHES = {"lovasz": 0}

# sorted rows of one class a tile of the kernel (``lovasz_tile_rows()`` of
# the library returns the same number)
TILE_ROWS = 2048


def _jaccard(gts, cum, pos):
    """``1 - (gts - cum) / max(gts + (pos + 1 - cum), 1)`` in float32, from
    exact integer counts."""
    inter = (gts - cum).to(torch.float32)
    union = (gts + (pos + 1 - cum)).to(torch.float32)
    return 1.0 - inter / torch.clamp(union, min=1.0)


def lovasz_grad(fg_sorted: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Gradient of the Lovász extension of the Jaccard loss along the sorted
    errors (``dim``) of the float32 foreground ``fg_sorted``."""
    gts = torch.sum(fg_sorted, dim=dim, keepdim=True)
    inter = gts - torch.cumsum(fg_sorted, dim=dim)
    union = gts + torch.cumsum(1.0 - fg_sorted, dim=dim)
    jaccard = 1.0 - inter / torch.clamp(union, min=1.0)
    j = jaccard.movedim(dim, 0)
    return torch.cat([j[:1], j[1:] - j[:-1]]).movedim(0, dim)


def lovasz_scan_plain(err_s: torch.Tensor, fg_s: torch.Tensor):
    """``(w [C, N], loss [C])``: :func:`lovasz_grad` along each sorted row
    and ``sum_i err_s * w`` per class."""
    w = lovasz_grad(fg_s.to(torch.float32), dim=1)
    return w, torch.sum(err_s * w, dim=1)


def lovasz_scan_tiled_plain(err_s: torch.Tensor, fg_s: torch.Tensor,
                            tile_rows: int = TILE_ROWS):
    """:func:`lovasz_scan_plain` computed the way the CUDA kernel computes
    it, for tests of its tile bookkeeping (slow: a Python loop over tiles).

    Pass 1: each tile's foreground count, in integers.  Pass 2, per tile:
    the counts of the tiles before it (its offset) and of all (``gts``), the
    inclusive prefix inside the tile from that offset, ``jac`` of each row
    and of the row before the tile's first (recomputed from the offset; 0
    before the first row), ``w`` as their differences, and the tile's dot
    product in float64.  Pass 3: each class's tile products summed in tile
    order, rounded to float32."""
    c, n = err_s.shape
    fg = (fg_s != 0).to(torch.int64)
    w = torch.full((c, n), float("nan"), dtype=torch.float32)
    tiles = -(-n // tile_rows)
    counts = torch.stack([fg[:, t * tile_rows:(t + 1) * tile_rows].sum(1)
                          for t in range(tiles)], 1) if tiles else \
        torch.zeros((c, 0), dtype=torch.int64)
    gts = counts.sum(1, keepdim=True)
    partial = torch.zeros((c, tiles), dtype=torch.float64)
    for t in range(tiles):
        t0, t1 = t * tile_rows, min((t + 1) * tile_rows, n)
        before = counts[:, :t].sum(1, keepdim=True)
        cum = before + torch.cumsum(fg[:, t0:t1], dim=1)
        pos = torch.arange(t0, t1, dtype=torch.int64)[None, :]
        jac = _jaccard(gts, cum, pos)
        prev = (_jaccard(gts, before, torch.tensor(t0 - 1)) if t0 > 0
                else torch.zeros((c, 1), dtype=torch.float32))
        w[:, t0:t1] = jac - torch.cat([prev, jac[:, :-1]], dim=1)
        partial[:, t] = torch.sum(err_s[:, t0:t1].double()
                                  * w[:, t0:t1].double(), dim=1)
    return w, partial.sum(1).to(torch.float32)


def _check_args(err_s, fg_s):
    if err_s.dtype != torch.float32 or fg_s.dtype != torch.uint8:
        raise TypeError(f"lovasz_scan takes float32 errors and uint8 "
                        f"foreground, got {err_s.dtype} and {fg_s.dtype}")
    if err_s.ndim != 2 or fg_s.shape != err_s.shape:
        raise ValueError(f"lovasz_scan: err_s and fg_s must be one [C, N] "
                         f"shape, got {tuple(err_s.shape)} and "
                         f"{tuple(fg_s.shape)}")
    if fg_s.device != err_s.device:
        raise TypeError("lovasz_scan: err_s and fg_s on one device")
    c, n = err_s.shape
    if n >= 2**30 or c > 65535:
        raise ValueError(f"lovasz_scan: the kernel takes N < 2^30 rows and "
                         f"at most 65535 classes, got [{c}, {n}]")


@functools.cache
def _check_library() -> None:
    """Once a process: the kernel's library tiles as this module does."""
    rows = cuda_build.load("lovasz").lovasz_tile_rows()
    if rows != TILE_ROWS:
        raise RuntimeError(f"csrc/lovasz.cu tiles {rows} rows, "
                           f"ops/lovasz.py {TILE_ROWS}")


def lovasz_scan(err_s: torch.Tensor, fg_s: torch.Tensor):
    """``(w [C, N], loss [C])`` of :func:`lovasz_scan_plain`.  CUDA tensors
    launch the kernel (counted in ``LAUNCHES``) or raise; CPU tensors take
    the plain version."""
    _check_args(err_s, fg_s)
    if err_s.device.type == "cpu":
        return lovasz_scan_plain(err_s, fg_s)
    if err_s.device.type != "cuda":
        raise RuntimeError(f"lovasz_scan: unsupported device {err_s.device}")
    _check_library()
    c, n = err_s.shape
    device = err_s.device
    err_s, fg_s = err_s.contiguous(), fg_s.contiguous()
    w = torch.empty((c, n), dtype=torch.float32, device=device)
    loss = torch.empty(c, dtype=torch.float32, device=device)
    # per class and tile an int32 count and a float64 partial product
    tiles = -(-n // TILE_ROWS)
    counts = torch.empty(c * tiles, dtype=torch.int32, device=device)
    partial = torch.empty(c * tiles, dtype=torch.float64, device=device)
    cuda_build.launch("lovasz", "lovasz_f32", device, (
        err_s.data_ptr(), fg_s.data_ptr(), w.data_ptr(), loss.data_ptr(),
        counts.data_ptr(), partial.data_ptr(), c, n), LAUNCHES)
    return w, loss


class _LovaszDot(torch.autograd.Function):
    """``lovasz_scan``'s products, differentiable in ``err_s``; saves ``w``."""

    @staticmethod
    def forward(ctx, err_s, fg_s):
        w, loss = lovasz_scan(err_s, fg_s)
        ctx.save_for_backward(w)
        return loss

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g[:, None] * w, None


def lovasz_dot(err_s: torch.Tensor, fg_s: torch.Tensor) -> torch.Tensor:
    """``loss [C]``, ``sum_i err_s[c, i] * w[c, i]`` of :func:`lovasz_scan`,
    differentiable in ``err_s`` (``fg_s`` takes no gradient)."""
    return _LovaszDot.apply(err_s, fg_s)
