"""The collectives of the parallel steps, over ``torch.distributed``.

The PyTorch side of the XLA collectives that ``shard_map`` inserts in the
JAX package: a differentiable all-reduce sum (``psum``, whose transpose under
``check_vma=False`` is a ``psum`` of the cotangent, mesh.py:109), a
differentiable all-gather of equal blocks (``all_gather(..., tiled=True)``,
whose transpose is a reduce-scatter sum, image_encoders.py:193) and an
in-place, bucketed mean (``pmean`` of the gradients and running statistics,
step.py:108-111).

NCCL groups use NCCL's own all-gather and reduce-scatter.  Gloo has neither
for every tensor type (no reduce-scatter at all, and fewer collectives on
CUDA tensors than on CPU tensors), so on gloo both are built from the
all-reduce: the gather as an all-reduce of zero-padded blocks (each element
is its owner's value plus zeros: exact), the reduce-scatter as an all-reduce
of the whole cotangent, sliced.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather_blocks", "all_reduce_mean_",
           "broadcast_", "BUCKET_BYTES"]

# flat buffer size of the bucketed collectives: the flagship's 202 MB of
# float32 gradients go in four calls
BUCKET_BYTES = 64 << 20


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its backward is the
    sum of the cotangents over the ranks."""
    return _AllReduceSum.apply(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    m, k, b = dist.get_world_size(group), dist.get_rank(group), x.shape[0]
    if _nccl(group):
        out = x.new_empty((m * b,) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = x.new_zeros((m * b,) + x.shape[1:])
    out[k * b:(k + 1) * b] = x
    dist.all_reduce(out, group=group)
    return out


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    m, k = dist.get_world_size(group), dist.get_rank(group)
    b = g.shape[0] // m
    if _nccl(group):
        out = g.new_empty((b,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, g, group=group)
        return out
    g = g.clone()
    dist.all_reduce(g, group=group)
    return g[k * b:(k + 1) * b].clone()


class _AllGatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group), None


def all_gather_blocks(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[b, ...]`` on each of the ``m`` ranks of ``group`` -> ``[m * b,
    ...]``, the blocks in rank order; its backward hands each rank the sum
    over the ranks of its block's cotangent (a reduce-scatter)."""
    return _AllGatherBlocks.apply(x, group)


def _buckets(tensors: Sequence[torch.Tensor],
             bucket_bytes: int) -> Iterator[List[torch.Tensor]]:
    """Runs of consecutive tensors of one dtype and device, each run up to
    ``bucket_bytes`` (a larger tensor makes a run of its own)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > bucket_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _flat_(tensors, bucket_bytes, collective) -> None:
    for run in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        for t, piece in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (the sum
    over the ranks, divided by their number), a few flat buffers of up to
    ``bucket_bytes`` at a time."""
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _flat_(tensors, bucket_bytes, mean)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite each tensor with global rank ``src``'s, in flat buffers."""
    _flat_(tensors, bucket_bytes,
           lambda flat: dist.broadcast(flat, src=src, group=group))
