"""Device-side sparse 3D convolution: gather -> one matmul. No scatter.

The port of the forward of ``deepviewagg_tpu/ops/sparse_conv.py``
(``sparse_conv``, ``sparse_conv_submanifold``, ``sparse_conv_pair``; the
role torchsparse / MinkowskiEngine play in the reference).  All indexing is
precomputed host-side as a dense neighbor table ``nbr int32 [K, cap_out]``
(pad = ``cap_in`` -> zero dump row); the device computation is an im2col:

    gathered[o, k] = feats[nbr[k, o]]           # [cap_out, K, Cin] gather
    out = gathered.reshape(cap_out, K*Cin) @ W.reshape(K*Cin, Cout)

Operands are rounded to bf16 and the products accumulate in float32 with a
float32 output, as the JAX package's ``preferred_element_type=f32`` dot
does: the rounded values are multiplied in float32 (TF32 must be off on the
card — ``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
The gather-GEMM stays plain PyTorch in this version of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sparse_conv", "sparse_conv_submanifold", "sparse_conv_pair",
           "add_dump_row"]


def add_dump_row(feats: torch.Tensor) -> torch.Tensor:
    """Append the zero dump row (index = capacity)."""
    return torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])


def _conv_core(feats, weights, nbr, compute_dtype=torch.bfloat16):
    k, cin, cout = weights.shape
    fp = add_dump_row(feats).to(compute_dtype).to(torch.float32)
    gathered = fp[nbr.t()].reshape(nbr.shape[1], k * cin)   # [cap_out, K*Cin]
    w = weights.to(compute_dtype).to(torch.float32).reshape(k * cin, cout)
    return gathered @ w


def sparse_conv(feats: torch.Tensor, weights: torch.Tensor, nbr: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Apply one sparse convolution: ``feats [cap_in, Cin]`` (no dump row),
    ``weights [K, Cin, Cout]``, ``nbr int32 [K, cap_out]`` (pad = cap_in)
    -> ``[cap_out, Cout]`` float32."""
    out = _conv_core(feats, weights, nbr, compute_dtype)
    if bias is not None:
        out = out + bias
    return out


def sparse_conv_submanifold(feats, weights, nbr, compute_dtype=torch.bfloat16):
    """Submanifold sparse conv (in-coords == out-coords, centered odd
    kernel); the forward is the shared gather-GEMM."""
    return _conv_core(feats, weights, nbr, compute_dtype)


def sparse_conv_pair(feats, weights, nbr, nbr_t, compute_dtype=torch.bfloat16):
    """Strided down / up conv whose transpose map ``nbr_t`` the graph
    builder precomputed (the JAX package's backward uses it; the forward is
    the shared gather-GEMM)."""
    del nbr_t
    return _conv_core(feats, weights, nbr, compute_dtype)
