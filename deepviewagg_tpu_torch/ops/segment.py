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
with one ``searchsorted``.

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

__all__ = [
    "LAUNCHES",
    "segment_csr",
    "segment_csr_plain",
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


def _segment_csr_forward(x, ptr, valid, reduce):
    """The forward of :func:`segment_csr` outside autograd."""
    _check_args("segment_csr", x, ptr, valid, x.shape[0])
    if x.device.type == "cpu":
        return segment_csr_plain(x, ptr, valid, reduce)
    if x.device.type != "cuda":
        raise RuntimeError(f"segment_csr: unsupported device {x.device}")
    from ..utils import cuda_build

    lib = cuda_build.load("segment_csr")
    x = x.contiguous()
    ptr = ptr.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    s = ptr.numel() - 1
    out = torch.empty((s, x.shape[1]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.segment_csr_f32(
            x.data_ptr(), ptr.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            s, x.shape[1], int(reduce == "max"),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"segment_csr kernel launch failed: CUDA error {rc}")
    LAUNCHES["segment_csr"] += 1
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
    if reduce == "max" and not (
            x.dtype == out.dtype == torch.float32 and x.shape == (e, c)
            and out.shape == g.shape and x.device == out.device == g.device):
        raise TypeError("segment_csr_bwd: x [E, C] and out [S, C] must be "
                        "float32 on g's device")
    if g.device.type == "cpu":
        return segment_csr_bwd_plain(g, x, out, ptr, valid, reduce, num_rows)
    if g.device.type != "cuda":
        raise RuntimeError(f"segment_csr_bwd: unsupported device {g.device}")
    if reduce == "max":
        x, out = x.contiguous(), out.contiguous()
    from ..utils import cuda_build

    lib = cuda_build.load("segment_csr_bwd")
    g = g.contiguous()
    ptr = ptr.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    gx = torch.empty((e, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.segment_csr_bwd_f32(
            g.data_ptr(),
            x.data_ptr() if reduce == "max" else None,
            out.data_ptr() if reduce == "max" else None,
            ptr.data_ptr(),
            None if valid is None else valid.data_ptr(), gx.data_ptr(),
            e, s, c, int(reduce == "max"),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"segment_csr_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["segment_csr_bwd"] += 1
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
                    scaling: bool = False, eps: float = 1e-12, ptr=None):
    """Numerically-stable softmax within each segment.

    ``scaling=True`` divides the max-shifted logits by ``sqrt(n_items)`` per
    segment before exponentiation (pooling.py:788-801).  Invalid elements get
    weight 0.
    """
    # the max shift leaves the softmax's value unchanged, so its gradient is
    # identically zero: cut it out of the backward
    seg_max = segment_max(logits.detach(), segment_ids, num_segments, valid,
                          ptr)
    logits = _masked(logits, valid, _NEG)
    shifted = logits - seg_max[segment_ids]
    if scaling:
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
