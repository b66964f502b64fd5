"""Segment (CSR) reductions — the workhorse of all view/pixel pooling.

The port of ``deepviewagg_tpu/ops/segment.py`` (the reference's
``torch_scatter.segment_csr`` / ``segment_softmax_csr`` / ``gather_csr``
stack, torch_points3d/modules/multimodal/pooling.py:7,759-920).  All
functions take **sorted** per-element segment ids plus a static
``num_segments``; padding elements carry ``segment_id == num_segments - 1``
with ``valid=False`` (callers allocate one extra "drop" segment).  Empty and
fully masked segments reduce to 0.

Every sorted-segment sum and max runs through :func:`segment_csr`: on a CUDA
tensor it launches the hand-written kernel ``csrc/segment_csr.cu`` (the port
of the TPU kernel ``deepviewagg_tpu/ops/pallas_segment.py::_scan_kernel``)
or raises; on a CPU tensor it runs :func:`segment_csr_plain`, the plain
PyTorch version with the same semantics.  The CSR ``ptr`` is used when the
caller gives it (collate ships ``point_ptr`` / ``pix_ptr``), else computed
with one ``searchsorted``.  The kernel cuts its work into tiles of
consecutive rows (:func:`kernel_tile_rows`) and joins the segments that
cross tile edges from partials in a scratch tensor;
:func:`segment_csr_tiled_plain` is that scheme in plain PyTorch and
:func:`segment_edge_cases` the inputs that exercise its edges (both for
tests only: nothing on the main path calls them).

:func:`segment_csr` is differentiable in ``x`` through a
``torch.autograd.Function`` whose backward is :func:`segment_csr_bwd`, the
port of the TPU kernel's hand-written backwards (``_sum_bwd`` / ``_max_bwd``):
on a CUDA tensor the kernel ``csrc/segment_csr_bwd.cu`` or an error, on a CPU
tensor :func:`segment_csr_bwd_plain`.  Sum passes the segment's cotangent to
every valid row; max passes it, whole, to every valid element that attains
the segment's maximum (ties included) and is above the masked fill.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import cuda_build

__all__ = [
    "LAUNCHES",
    "segment_csr",
    "segment_csr_plain",
    "segment_csr_tiled_plain",
    "segment_edge_cases",
    "kernel_tile_rows",
    "segment_csr_bwd",
    "segment_csr_bwd_plain",
    "segment_ptr",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_reduce",
    "segment_count",
    "gather_segments",
    "segment_softmax",
    "segment_weighted_sum",
    "segment_argmax",
    "segment_argmin",
]

_NEG = -1e30

# launches of each hand-written kernel, counted where the wrapper launches it
LAUNCHES = {"segment_csr": 0, "segment_csr_bwd": 0}


def segment_ptr(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR pointers ``int32 [num_segments + 1]`` of sorted ids."""
    groups = torch.arange(num_segments + 1, device=segment_ids.device,
                          dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids.contiguous(), groups,
                              out_int32=True)


def segment_csr_plain(x: torch.Tensor, ptr: torch.Tensor,
                      valid: Optional[torch.Tensor], reduce: str) -> torch.Tensor:
    """Plain PyTorch sorted-segment reduction: ``out[s] = reduce over rows
    [ptr[s], ptr[s+1])`` of ``x [E, C]`` where ``valid``; 0 for empty or fully
    masked segments; rows outside ``[ptr[0], ptr[-1])`` are ignored."""
    e, c = x.shape
    s = ptr.numel() - 1
    out = torch.zeros((s, c), dtype=x.dtype, device=x.device)
    if s == 0 or e == 0:
        return out
    ids, keep = _row_segments(ptr, e)
    if valid is not None:
        keep = keep & valid
    if reduce == "sum":
        return out.index_add_(0, ids, torch.where(keep[:, None], x, 0.0))
    if reduce == "max":
        xm = torch.where(keep[:, None], x, _NEG)
        out.scatter_reduce_(0, ids[:, None].expand(e, c), xm, "amax",
                            include_self=False)
        return torch.where(out <= _NEG / 2, 0.0, out)
    raise ValueError(reduce)


def _row_segments(ptr: torch.Tensor, num_rows: int):
    """``(ids int64 [E] clamped into [0, S-1], inside bool [E])``: the segment
    of each row under ``ptr``, and whether the row lies in
    ``[ptr[0], ptr[-1])``."""
    s = ptr.numel() - 1
    rows = torch.arange(num_rows, device=ptr.device)
    ids = torch.searchsorted(ptr.to(torch.int64), rows, right=True) - 1
    inside = (ids >= 0) & (ids < s)
    return ids.clamp(0, max(s - 1, 0)), inside


def segment_csr_tiled_plain(x: torch.Tensor, ptr: torch.Tensor,
                            valid: Optional[torch.Tensor], reduce: str,
                            tile_rows: int) -> torch.Tensor:
    """:func:`segment_csr_plain` computed the way the CUDA kernel computes
    it, for tests of the tile-edge bookkeeping (slow: Python loops).

    Pass 1, per tile ``[t0, t1)`` of ``tile_rows`` rows: the segments that
    start in the tile and hold a row are its own; an own segment that ends in
    the tile is reduced and written; the segment that comes in from an
    earlier tile (head) and the last own one when it runs on (tail) leave
    unfinished partials ``[tiles, 2, C]``.  Pass 2: the empty segments get
    zeros, and per tile whose head ends in it: tail of the segment's first
    tile, then the heads, in tile order.  Every output row is written
    exactly once (the result starts as NaN and a second write raises)."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    import bisect

    e, c = x.shape
    s = ptr.numel() - 1
    if s == 0 or e == 0:
        return torch.zeros((s, c), dtype=x.dtype, device=x.device)
    out = torch.full((s, c), float("nan"), dtype=x.dtype, device=x.device)
    written = [False] * s

    def write(seg, value):
        if written[seg]:
            raise AssertionError(f"segment {seg} written twice")
        written[seg] = True
        out[seg] = value

    is_max = reduce == "max"
    ident = _NEG if is_max else 0.0
    p = [int(v) for v in ptr.tolist()]
    live = (torch.ones(e, dtype=torch.bool, device=x.device)
            if valid is None else valid)
    tiles = -(-e // tile_rows)
    partial = torch.full((tiles, 2, c), float("nan"), dtype=x.dtype,
                         device=x.device)

    def raw(r0, r1):
        rows = x[r0:r1][live[r0:r1]]
        if rows.shape[0] == 0:
            return torch.full((c,), ident, dtype=x.dtype, device=x.device)
        return rows.amax(0) if is_max else rows.sum(0)

    def join(a, b):
        return torch.maximum(a, b) if is_max else a + b

    def finish(a):
        return torch.where(a <= _NEG / 2, 0.0, a) if is_max else a

    def bounds(t):
        t0 = t * tile_rows
        return t0, (e if t == tiles - 1 else t0 + tile_rows)

    for t in range(tiles):
        t0, t1 = bounds(t)
        first = bisect.bisect_left(p, t0)
        if 1 <= first <= s and p[first] > t0:            # head
            partial[t, 0] = raw(t0, min(p[first], t1))
        for seg in range(first, min(bisect.bisect_left(p, t1), s)):
            if p[seg + 1] == p[seg]:                     # empty: pass 2
                continue
            if p[seg + 1] > t1:                          # tail
                partial[t, 1] = raw(p[seg], t1)
            else:
                write(seg, finish(raw(p[seg], p[seg + 1])))
    for seg in range(s):
        if p[seg + 1] == p[seg]:
            write(seg, 0.0)
    for t in range(tiles):
        t0, t1 = bounds(t)
        first = bisect.bisect_left(p, t0)
        if not (1 <= first <= s and t0 < p[first] <= t1):
            continue
        start = p[first - 1] // tile_rows
        acc = partial[start, 1]
        for u in range(start + 1, t + 1):
            acc = join(acc, partial[u, 0])
        write(first - 1, finish(acc))
    if not all(written):
        raise AssertionError("a segment was never written")
    return out


def segment_edge_cases(tile_rows: int, channels: int, seed: int = 0):
    """Inputs that exercise every edge of a kernel tiled by ``tile_rows``
    rows: ``[(name, x [E, C], ptr int32 [S+1], valid bool [E] or None)]`` as
    CPU tensors, drawn with numpy from ``seed``.  The values are multiples of
    1/64, so that a float32 sum of a few thousand of them is exact in any
    order: a difference between two implementations is a fault of their
    bookkeeping, not of their rounding."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = tile_rows

    def case(name, lengths, before=0, after=0, dead=(), dead_rows=(0, 0),
             masked=0.2, with_valid=True):
        """Segments of the given lengths after ``before`` rows outside every
        segment, ``after`` such rows at the end; the segments listed in
        ``dead`` and the rows ``dead_rows`` fully masked, other rows masked
        with probability ``masked``."""
        ptr = before + np.concatenate([[0], np.cumsum(lengths)])
        e = int(ptr[-1]) + after
        x = (np.round(rng.normal(size=(e, channels)) * 64) / 64).astype(
            np.float32)
        valid = rng.random(e) >= masked
        valid[dead_rows[0]:dead_rows[1]] = False
        for d in dead:
            valid[ptr[d]:ptr[d + 1]] = False
        return (name, torch.from_numpy(x),
                torch.from_numpy(ptr.astype(np.int32)),
                torch.from_numpy(valid) if with_valid else None)

    short = lambda n: rng.integers(0, 7, n).tolist()        # noqa: E731
    # live segments (one longer than a tile) with runs of up to 8 empty ones
    # between them, then a masked drop segment
    spread = sum(([n + 1] + [0] * k for n, k in zip(
        [5] + short(30) + [t + 2] + short(30),
        rng.integers(0, 9, 62).tolist())), []) + [t // 2]
    return [
        # one segment over several tiles, short ones around it
        case("long", short(9) + [3 * t + t // 2 + 5] + short(9)),
        case("long_unmasked", [2, 2 * t + 3, 1], with_valid=False),
        # segments that start and end exactly on tile edges
        case("on_edges", [t - 3, 3, t, 2 * t, 5, t - 5, 4]),
        # empty segments at a tile edge, and behind the last row
        case("empty_at_edge", [t - 2, 2, 0, 0, 0, 5, t - 5, 0, 0, t, 0, 0]),
        # a tile with no live row inside live segments
        case("dead_tile", [t // 2, 3 * t, 7], dead_rows=(t, 2 * t),
             masked=0.0),
        # a fully masked run of tiles between live segments (a drop segment
        # in the middle), many short dead segments too
        case("drop_in_middle", short(20) + [3 * t + 11] + short(20),
             dead=(20, 3, 4, 30)),
        # rows before ptr[0] and behind ptr[S]
        case("offset", short(15) + [t + 3] + short(5), before=t + 7,
             after=t // 2 + 1),
        case("offset_small", [3, 0, 2], before=5, after=4),
        # fewer rows than one tile; a single segment
        case("under_one_tile", [2, 0, 3, 1, 4]),
        case("one_segment", [2 * t + 9]),
        case("one_segment_short", [5]),
        case("one_empty_segment", [0], after=3),
        case("no_rows", [0, 0]),
        # a crop-ladder bucket without a pixel: more empty segments than a
        # tile has rows, all owned by the first tile, then one fully masked
        # drop segment that holds every row
        case("all_empty_all_masked", [0] * (2 * t + 3) + [t // 4 + 1],
             dead=(2 * t + 3,)),
        # a crop-ladder bucket that holds some of the views: runs of empty
        # segments between the live ones, across tile edges, dead ones too
        case("empties_between_live", spread, dead=(0, len(spread) - 1)),
    ]


def segment_csr_bwd_plain(g: torch.Tensor, x: Optional[torch.Tensor],
                          out: Optional[torch.Tensor], ptr: torch.Tensor,
                          valid: Optional[torch.Tensor], reduce: str,
                          num_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch gradient of :func:`segment_csr_plain` in ``x``:
    ``gx[r] = g[s(r)]`` where row ``r`` lies in segment ``s(r)`` and is
    valid, else 0; for ``'max'`` only where ``x[r, c] == out[s(r), c]`` and
    ``x[r, c] > -5e29`` (every max-attaining element gets the full
    cotangent).  ``x`` and ``out`` (the forward's input and result) are read
    for ``'max'`` only; ``'sum'`` takes ``num_rows`` when ``x`` is None."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    e = x.shape[0] if x is not None else int(num_rows)
    c = g.shape[1]
    if e == 0 or ptr.numel() <= 1:
        return torch.zeros((e, c), dtype=g.dtype, device=g.device)
    ids, keep = _row_segments(ptr, e)
    if valid is not None:
        keep = keep & valid
    mask = keep[:, None]
    if reduce == "max":
        mask = mask & (x == out[ids]) & (x > _NEG / 2)
    return torch.where(mask, g[ids], 0.0)


def _check_args(name, x, ptr, valid, num_rows):
    """What both the kernels and their plain versions take: float32 ``[.,
    C]`` values, an int32 ``ptr`` and a bool ``valid [E]`` on one device."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {x.dtype}")
    if x.ndim != 2 or ptr.ndim != 1:
        raise ValueError(f"{name}: x must be [E, C] and ptr [S+1], got "
                         f"{tuple(x.shape)} and {tuple(ptr.shape)}")
    if ptr.dtype != torch.int32 or ptr.device != x.device:
        raise TypeError(f"{name}: ptr must be int32 on x's device")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (num_rows,)
                              or valid.device != x.device):
        raise TypeError(f"{name}: valid must be bool [E] on x's device")
    if num_rows > 2**31 - 1024:
        raise ValueError(f"{name}: the kernel indexes rows with int32")


def kernel_tile_rows(channels: int) -> int:
    """Rows per tile of the forward kernel for ``[E, channels]`` inputs:
    the fastest of a sweep of tile sizes (32-2048) over the flagship's
    calls on an H100."""
    return 512 if 2 < channels < 128 else 1024


def _ptr_or_none(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _contiguous(t: Optional[torch.Tensor]):
    return t if t is None or t.is_contiguous() else t.contiguous()


def _segment_csr_forward(x, ptr, valid, reduce):
    """The forward of :func:`segment_csr` outside autograd."""
    _check_args("segment_csr", x, ptr, valid, x.shape[0])
    if x.device.type == "cpu":
        return segment_csr_plain(x, ptr, valid, reduce)
    if x.device.type != "cuda":
        raise RuntimeError(f"segment_csr: unsupported device {x.device}")
    e, c = x.shape
    s = ptr.numel() - 1
    tile_rows = kernel_tile_rows(c)
    x, ptr, valid = _contiguous(x), _contiguous(ptr), _contiguous(valid)
    out = torch.empty((s, c), dtype=torch.float32, device=x.device)
    # per tile two partial rows (the segments that cross its edges) and two
    # int32 of bookkeeping
    scratch = torch.empty(-(-e // tile_rows) * (2 * c + 2),
                          dtype=torch.float32, device=x.device)
    cuda_build.launch("segment_csr", "segment_csr_f32", x.device, (
        x.data_ptr(), ptr.data_ptr(), _ptr_or_none(valid), out.data_ptr(),
        scratch.data_ptr(), e, s, c, int(reduce == "max"), tile_rows),
        LAUNCHES)
    return out


def segment_csr_bwd(g: torch.Tensor, x: Optional[torch.Tensor],
                    out: Optional[torch.Tensor], ptr: torch.Tensor,
                    valid: Optional[torch.Tensor], reduce: str,
                    num_rows: Optional[int] = None) -> torch.Tensor:
    """Gradient of :func:`segment_csr` in ``x``: ``g [S, C]`` float32 ->
    ``gx [E, C]`` (the arguments of :func:`segment_csr_bwd_plain`).  CUDA
    tensors launch the backward kernel (counted in ``LAUNCHES``) or raise;
    CPU tensors take the plain version."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    if reduce == "max" and (x is None or out is None):
        raise ValueError("segment_csr_bwd: 'max' needs x and out")
    e = x.shape[0] if x is not None else int(num_rows)
    _check_args("segment_csr_bwd", g, ptr, valid, e)
    s, c = ptr.numel() - 1, g.shape[1]
    if g.shape[0] != s:
        raise ValueError(f"segment_csr_bwd: g has {g.shape[0]} rows for "
                         f"{s} segments")
    is_max = reduce == "max"
    if is_max and not (
            x.dtype == out.dtype == torch.float32 and x.shape == (e, c)
            and out.shape == g.shape and x.device == out.device == g.device):
        raise TypeError("segment_csr_bwd: x [E, C] and out [S, C] must be "
                        "float32 on g's device")
    if g.device.type == "cpu":
        return segment_csr_bwd_plain(g, x, out, ptr, valid, reduce, num_rows)
    if g.device.type != "cuda":
        raise RuntimeError(f"segment_csr_bwd: unsupported device {g.device}")
    g, ptr, valid = _contiguous(g), _contiguous(ptr), _contiguous(valid)
    # the copies stay bound until the launch: a freed one's block could
    # take the next copy before the kernel reads it
    x, out = (_contiguous(x), _contiguous(out)) if is_max else (None, None)
    gx = torch.empty((e, c), dtype=torch.float32, device=g.device)
    cuda_build.launch("segment_csr_bwd", "segment_csr_bwd_f32", g.device, (
        g.data_ptr(), _ptr_or_none(x), _ptr_or_none(out), ptr.data_ptr(),
        _ptr_or_none(valid), gx.data_ptr(), e, s, c, int(is_max)), LAUNCHES)
    return gx


class _SegmentCSR(torch.autograd.Function):
    """``segment_csr`` with the hand-written backward; saves ``(x, out)`` for
    ``'max'`` and nothing of ``x`` for ``'sum'``."""

    @staticmethod
    def forward(ctx, x, ptr, valid, reduce):
        out = _segment_csr_forward(x, ptr, valid, reduce)
        ctx.reduce = reduce
        ctx.num_rows = x.shape[0]
        ctx.has_valid = valid is not None
        saved = [ptr] + ([valid] if valid is not None else [])
        if reduce == "max":
            saved += [x, out]
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = list(ctx.saved_tensors)
        ptr = saved.pop(0)
        valid = saved.pop(0) if ctx.has_valid else None
        x, out = saved if ctx.reduce == "max" else (None, None)
        gx = segment_csr_bwd(g.contiguous(), x, out, ptr, valid, ctx.reduce,
                             ctx.num_rows)
        return gx, None, None, None


def segment_csr(x: torch.Tensor, ptr: torch.Tensor,
                valid: Optional[torch.Tensor], reduce: str) -> torch.Tensor:
    """Sorted-segment ``'sum'`` or ``'max'`` of ``x [E, C]`` float32 over CSR
    ``ptr int32 [S+1]`` -> ``[S, C]``, differentiable in ``x``.  CUDA tensors
    launch the kernels (counted in ``LAUNCHES``); CPU tensors take
    :func:`segment_csr_plain` and :func:`segment_csr_bwd_plain`."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    if not (torch.is_grad_enabled() and x.requires_grad):
        # nothing to differentiate: spare the autograd function's host cost
        return _segment_csr_forward(x, ptr, valid, reduce)
    return _SegmentCSR.apply(x, ptr, valid, reduce)


def _masked(x, valid, fill):
    if valid is None:
        return x
    v = valid.reshape(valid.shape + (1,) * (x.ndim - valid.ndim))
    return torch.where(v, x, fill)


def _reduce(x, segment_ids, num_segments, valid, ptr, reduce):
    if ptr is None:
        ptr = segment_ptr(segment_ids, num_segments)
    elif ptr.dtype != torch.int32:
        ptr = ptr.to(torch.int32)
    out = segment_csr(x.reshape(x.shape[0], -1), ptr, valid, reduce)
    return out.reshape((num_segments,) + tuple(x.shape[1:]))


def segment_sum(x, segment_ids, num_segments: int, valid=None, ptr=None):
    return _reduce(x, segment_ids, num_segments, valid, ptr, "sum")


def segment_count(segment_ids, num_segments: int, valid=None, ptr=None):
    if ptr is not None and valid is None:
        # CSR pointer diff — no reduction at all
        return (ptr[1:] - ptr[:-1]).to(torch.float32)
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, valid, ptr)


def segment_mean(x, segment_ids, num_segments: int, valid=None, ptr=None):
    s = segment_sum(x, segment_ids, num_segments, valid, ptr)
    n = segment_count(segment_ids, num_segments, valid, ptr)
    n = n.reshape(n.shape + (1,) * (s.ndim - n.ndim))
    return s / torch.clamp(n, min=1.0)


def segment_max(x, segment_ids, num_segments: int, valid=None, ptr=None):
    return _reduce(x, segment_ids, num_segments, valid, ptr, "max")


def segment_min(x, segment_ids, num_segments: int, valid=None, ptr=None):
    return -_reduce(-x, segment_ids, num_segments, valid, ptr, "max")


def segment_reduce(x, segment_ids, num_segments: int, reduce: str, valid=None,
                   ptr=None):
    """Dispatch on reduce name — mirrors ``BimodalCSRPool`` modes
    (pooling.py:14-71): max / mean / min / sum."""
    fn = {
        "sum": segment_sum,
        "add": segment_sum,
        "mean": segment_mean,
        "max": segment_max,
        "min": segment_min,
    }[reduce]
    return fn(x, segment_ids, num_segments, valid, ptr)


def gather_segments(y, segment_ids):
    """Broadcast per-segment values back to elements (``gather_csr``,
    pooling.py:814)."""
    return y[segment_ids]


def segment_softmax(logits, segment_ids, num_segments: int, valid=None,
                    scaling: bool = False, eps: float = 1e-12, ptr=None,
                    seg_max=None, count=None):
    """Numerically-stable softmax within each segment.

    ``scaling=True`` divides the max-shifted logits by ``sqrt(n_items)`` per
    segment before exponentiation (pooling.py:788-801).  Invalid elements get
    weight 0.  A caller that already holds the logits' per-segment maximum
    (``seg_max``, detached) or the per-segment count of valid elements
    (``count``) passes them in and saves those reductions.
    """
    # the max shift leaves the softmax's value unchanged, so its gradient is
    # identically zero: cut it out of the backward
    if seg_max is None:
        seg_max = segment_max(logits.detach(), segment_ids, num_segments,
                              valid, ptr)
    logits = _masked(logits, valid, _NEG)
    shifted = logits - seg_max[segment_ids]
    if scaling:
        n = count
        if n is None:
            n = segment_count(segment_ids, num_segments, valid, ptr)
        denom = torch.sqrt(torch.clamp(n, min=1.0))[segment_ids]
        denom = denom.reshape(denom.shape + (1,) * (shifted.ndim - denom.ndim))
        shifted = shifted / denom
    e = _masked(torch.exp(shifted), valid, 0.0)
    seg_sum = segment_sum(e, segment_ids, num_segments, ptr=ptr)
    return e / (seg_sum[segment_ids] + eps)


def segment_weighted_sum(x, weights, segment_ids, num_segments: int,
                         valid=None, ptr=None):
    """``sum_i w_i * x_i`` per segment — the attention-pooled value of
    ``GroupBimodalCSRPool`` (pooling.py:297-308)."""
    if weights.ndim < x.ndim:
        weights = weights.reshape(weights.shape + (1,) * (x.ndim - weights.ndim))
    return segment_sum(x * weights, segment_ids, num_segments, valid, ptr)


def _segment_arg(x, segment_ids, num_segments, valid, ptr, best_fn):
    """First index attaining the per-segment extremum ``best_fn`` among the
    valid elements of 1-D ``x``, and the non-empty mask (reference Heuristic
    pool argmax / argmin, pooling.py:74-158).  The extremum is a
    :func:`segment_csr` reduction; the first-index step is plain PyTorch."""
    best = best_fn(x, segment_ids, num_segments, valid, ptr)
    is_best = x == best[segment_ids]
    if valid is not None:
        is_best = is_best & valid
    e = x.shape[0]
    cand = torch.where(is_best,
                       torch.arange(e, device=x.device, dtype=torch.int64), e)
    arg = torch.full((num_segments,), e, dtype=torch.int64, device=x.device)
    arg.scatter_reduce_(0, segment_ids.to(torch.int64), cand, "amin")
    return torch.clamp(arg, 0, max(e - 1, 0)), arg < e


def segment_argmax(x, segment_ids, num_segments: int, valid=None, ptr=None):
    return _segment_arg(x, segment_ids, num_segments, valid, ptr, segment_max)


def segment_argmin(x, segment_ids, num_segments: int, valid=None, ptr=None):
    return _segment_arg(x, segment_ids, num_segments, valid, ptr, segment_min)
