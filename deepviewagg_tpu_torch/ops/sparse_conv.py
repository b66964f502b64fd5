"""Device-side sparse 3D convolution: gather -> one matmul. No scatter.

The port of ``deepviewagg_tpu/ops/sparse_conv.py`` (``sparse_conv``,
``sparse_conv_submanifold``, ``sparse_conv_pair``; the role torchsparse /
MinkowskiEngine play in the reference).  All indexing is precomputed
host-side as a dense neighbor table ``nbr int32 [K, cap_out]`` (pad =
``cap_in`` -> zero dump row); the device computation is an im2col:

    gathered[o, k] = feats[nbr[k, o]]           # [cap_out, K, Cin] gather
    out = gathered.reshape(cap_out, K*Cin) @ W.reshape(K*Cin, Cout)

Operands are rounded to ``compute_dtype`` (bf16) and the products accumulate
in float32 with a float32 output, as the JAX package's
``preferred_element_type=f32`` dot does: the rounded values are multiplied in
float32 (TF32 must be off on the card —
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

``sparse_conv_submanifold`` and ``sparse_conv_pair`` carry the JAX package's
gather-only backwards (``_subm_bwd`` / ``_pair_bwd``) as
``torch.autograd.Function``s: ``dfeats`` is another gather-GEMM over the
transposed map (the same table with the K axis reversed for a submanifold
conv, the precomputed ``nbr_t`` for a strided pair), ``dW`` re-gathers the
activations; the cotangent, the weights and the gathered rows are rounded to
``compute_dtype`` like the forward's operands, and only ``(feats, weights,
nbr[, nbr_t])`` are saved: no im2col outlives its matmul.  Plain
``sparse_conv`` (with bias) keeps ordinary autograd.  The gather-GEMMs stay
plain PyTorch in this version of the port.  ``sparse_global_pool`` (the
classification head's per-sample pool) runs the sorted-segment kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import segment as _seg

__all__ = ["sparse_conv", "sparse_conv_submanifold", "sparse_conv_pair",
           "add_dump_row", "sparse_gather", "sparse_global_pool"]


def add_dump_row(feats: torch.Tensor) -> torch.Tensor:
    """Append the zero dump row (index = capacity)."""
    return torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])


def sparse_gather(feats: torch.Tensor, idx: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Rows ``feats[idx]`` (any index shape), an index at or past the end
    reading a row of ``fill``; a negative index counts from the end of
    ``feats`` plus that fill row, as a JAX gather wraps it."""
    n = feats.shape[0]
    fp = torch.cat([feats, feats.new_full((1, feats.shape[1]), fill)])
    i = torch.clamp(torch.as_tensor(idx, device=feats.device).to(torch.int64),
                    max=n)
    i = torch.clamp(torch.where(i < 0, i + n + 1, i), min=0)
    return fp.index_select(0, i.reshape(-1)).reshape(*i.shape, feats.shape[1])


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    return t.to(compute_dtype).to(torch.float32)


def _gather(rows: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``[cap_out, K * C]`` im2col of ``rows [cap + 1, C]`` (dump row last)."""
    return rows[nbr.t()].reshape(nbr.shape[1], nbr.shape[0] * rows.shape[1])


def _conv_core(feats, weights, nbr, compute_dtype=torch.bfloat16):
    k, cin, cout = weights.shape
    fp = _rounded(add_dump_row(feats), compute_dtype)
    w = _rounded(weights, compute_dtype).reshape(k * cin, cout)
    return _gather(fp, nbr) @ w


def _conv_backward(ctx, g, feats, weights, nbr, nbr_t, w_t):
    """``(dfeats, dW)`` of ``_conv_core``: ``dfeats`` gathers the cotangent
    through ``nbr_t`` against ``w_t [K, Cout, Cin]``; ``dW[k] = gathered_k^T
    g``."""
    k, cin, cout = weights.shape
    cd = ctx.compute_dtype
    g = _rounded(g, cd)
    dfeats = dw = None
    if ctx.needs_input_grad[0]:
        dfeats = (_gather(add_dump_row(g), nbr_t)
                  @ _rounded(w_t, cd).reshape(k * cout, cin))[:feats.shape[0]]
    if ctx.needs_input_grad[1]:
        fp = _rounded(add_dump_row(feats), cd)
        dw = (_gather(fp, nbr).t() @ g).reshape(k, cin, cout)
    return dfeats, dw


class _SubmanifoldConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weights, nbr, compute_dtype):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(feats, weights, nbr)
        return _conv_core(feats, weights, nbr, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        feats, weights, nbr = ctx.saved_tensors
        # dfeats[i] = sum_k g[nbr[k, i]] @ W[K-1-k]^T: the neighbor at offset
        # k of i contributes through the NEGATED offset's weights, and
        # negating an offset reverses the lexicographic enumeration of a
        # centered odd cube
        w_t = torch.flip(weights.transpose(1, 2), dims=(0,))
        dfeats, dw = _conv_backward(ctx, g, feats, weights, nbr, nbr, w_t)
        return dfeats, dw, None, None


class _PairConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weights, nbr, nbr_t, compute_dtype):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(feats, weights, nbr, nbr_t)
        return _conv_core(feats, weights, nbr, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        feats, weights, nbr, nbr_t = ctx.saved_tensors
        # the transpose map inverts each offset's partial injection: same
        # offset index, no K reversal
        dfeats, dw = _conv_backward(ctx, g, feats, weights, nbr, nbr_t,
                                    weights.transpose(1, 2))
        return dfeats, dw, None, None, None


def sparse_conv(feats: torch.Tensor, weights: torch.Tensor, nbr: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Apply one sparse convolution: ``feats [cap_in, Cin]`` (no dump row),
    ``weights [K, Cin, Cout]``, ``nbr int32 [K, cap_out]`` (pad = cap_in)
    -> ``[cap_out, Cout]`` float32.  Differentiated by ordinary autograd."""
    out = _conv_core(feats, weights, nbr, compute_dtype)
    if bias is not None:
        out = out + bias
    return out


def sparse_conv_submanifold(feats, weights, nbr, compute_dtype=torch.bfloat16):
    """Submanifold sparse conv (in-coords == out-coords, centered odd
    kernel) with the gather-only backward."""
    return _SubmanifoldConv.apply(feats, weights, nbr, compute_dtype)


def sparse_conv_pair(feats, weights, nbr, nbr_t, compute_dtype=torch.bfloat16):
    """Strided down / up conv whose transpose map ``nbr_t`` comes
    precomputed with the graph (each one's transpose is the other's table);
    the backward gathers through ``nbr_t``."""
    return _PairConv.apply(feats, weights, nbr, nbr_t, compute_dtype)


def sparse_global_pool(feats, batch_idx, num_batches: int, valid=None,
                       reduce: str = "mean"):
    """Per-sample global pooling over a sparse tensor (encoder heads):
    ``batch_idx`` must be sorted (the graph's levels come out of
    ``unique_coords`` in key order, padding in the last slot), since the
    reduction runs through the sorted-segment kernel of :mod:`.segment`."""
    return _seg.segment_reduce(feats, batch_idx, num_batches, reduce=reduce,
                               valid=valid)
