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
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "LAUNCHES",
    "segment_csr",
    "segment_csr_plain",
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
LAUNCHES = {"segment_csr": 0}


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
    rows = torch.arange(e, device=x.device)
    ids = torch.searchsorted(ptr.to(torch.int64), rows, right=True) - 1
    keep = (ids >= 0) & (ids < s)
    if valid is not None:
        keep = keep & valid
    ids = ids.clamp(0, max(s - 1, 0))
    out = torch.zeros((s, c), dtype=x.dtype, device=x.device)
    if s == 0 or e == 0:
        return out
    if reduce == "sum":
        return out.index_add_(0, ids, torch.where(keep[:, None], x, 0.0))
    if reduce == "max":
        xm = torch.where(keep[:, None], x, _NEG)
        out.scatter_reduce_(0, ids[:, None].expand(e, c), xm, "amax",
                            include_self=False)
        return torch.where(out <= _NEG / 2, 0.0, out)
    raise ValueError(reduce)


def segment_csr(x: torch.Tensor, ptr: torch.Tensor,
                valid: Optional[torch.Tensor], reduce: str) -> torch.Tensor:
    """Sorted-segment ``'sum'`` or ``'max'`` of ``x [E, C]`` float32 over CSR
    ``ptr int32 [S+1]`` -> ``[S, C]``.  CUDA tensors launch the kernel
    (counted in ``LAUNCHES``); CPU tensors take :func:`segment_csr_plain`."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    if x.device.type == "cpu":
        return segment_csr_plain(x, ptr, valid, reduce)
    if x.device.type != "cuda":
        raise RuntimeError(f"segment_csr: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"segment_csr kernel takes float32, got {x.dtype}")
    if x.ndim != 2 or ptr.ndim != 1:
        raise ValueError(f"segment_csr: x must be [E, C] and ptr [S+1], got "
                         f"{tuple(x.shape)} and {tuple(ptr.shape)}")
    if ptr.dtype != torch.int32 or ptr.device != x.device:
        raise TypeError("segment_csr: ptr must be int32 on x's device")
    if x.shape[0] > 2**31 - 1024:
        raise ValueError("segment_csr: the kernel indexes rows with int32")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != x.shape[:1]
                              or valid.device != x.device):
        raise TypeError("segment_csr: valid must be bool [E] on x's device")
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
    seg_max = segment_max(logits, segment_ids, num_segments, valid, ptr)
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
