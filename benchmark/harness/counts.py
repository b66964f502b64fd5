"""The yardstick's arithmetic: model FLOPs of a step, byte bounds of the
sorted-segment kernels, and the peaks of the card.

Model FLOPs count the multiply-adds the model's mathematics requires (two
FLOPs each) for the real rows of a batch: the 2D convolutions of the towers
on the images that a mapped pixel reads, from their shapes; the sparse
convolutions as 2 x pairs x C_in x C_out, the pairs counted from the
voxels' coordinates by the reference's own lookup (:mod:`..reference.graph`);
the linear layers of the view pool, the skip projections and the head; the
bilinear taps of the pixel gather and the attention-weighted sum.  A
training step counts three times its forward (forward and backward); work
recomputed to save memory and work on padding rows does not count.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["PEAKS", "peak_for", "forward_flops", "segment_fwd_bytes",
           "segment_bwd_bytes"]

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak_for(device_name: str) -> Dict[str, float]:
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    raise KeyError(f"no peaks for {device_name!r}")


def _conv_out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _tower_flops(shapes, pre, n_img, w, h) -> float:
    f = 0.0
    i = 0
    while f"{pre}.Conv2dWS_{i}.weight" in shapes:
        o, c, kw, kh = shapes[f"{pre}.Conv2dWS_{i}.weight"]
        s = 2 if i == 0 else 1
        w, h = _conv_out(w, kw, s, kw // 2), _conv_out(h, kh, s, kh // 2)
        f += 2.0 * n_img * w * h * o * c * kw * kh
        i += 1
    w, h = _conv_out(w, 3, 2, 1), _conv_out(h, 3, 2, 1)
    b = 0
    while f"{pre}._BasicBlock2d_{b}.Conv2dWS_0.weight" in shapes:
        bp = f"{pre}._BasicBlock2d_{b}"
        s = 2 if (b >= 2 and b % 2 == 0) else 1
        o, c, kw, kh = shapes[bp + ".Conv2dWS_0.weight"]
        w2, h2 = _conv_out(w, kw, s, kw // 2), _conv_out(h, kh, s, kh // 2)
        f += 2.0 * n_img * w2 * h2 * o * c * kw * kh
        o1, c1, kw1, kh1 = shapes[bp + ".Conv2dWS_1.weight"]
        f += 2.0 * n_img * w2 * h2 * o1 * c1 * kw1 * kh1
        if bp + ".Conv2dWS_2.weight" in shapes:
            o2, c2, _, _ = shapes[bp + ".Conv2dWS_2.weight"]
            f += 2.0 * n_img * w2 * h2 * o2 * c2
        w, h = w2, h2
        b += 1
    return f, (w, h)


def _mlp_flops(shapes, pre, rows) -> float:
    f, i = 0.0, 0
    while f"{pre}.Dense_{i}.weight" in shapes:
        o, c = shapes[f"{pre}.Dense_{i}.weight"]
        f += 2.0 * rows * o * c
        i += 1
    return f


def forward_flops(shapes: Mapping[str, tuple], inp: Dict, graph) -> float:
    """Model FLOPs of one forward over the reference inputs ``inp`` of a
    batch (:func:`..reference.model.inputs_from_batch`) with its
    ``graph`` (:func:`..reference.graph.build_graph`); ``shapes``: the
    parameters' shapes by name."""
    from ..reference.model import branch_names

    n = inp["feats"].shape[0]
    nv = inp["views"]["point_id"].shape[0]
    f = 0.0
    for name in branch_names(shapes):
        c_tower = shapes[name + ".view_pool.e_mod.Dense_0.weight"][1]
        for bk in inp["buckets"]:
            q = bk["pix_view"].shape[0]
            if q == 0:
                continue
            n_img = int(torch.unique(bk["pix_image"]).numel())
            w, h = bk["images"].shape[1], bk["images"].shape[2]
            tf, (wf, hf) = _tower_flops(shapes, name + ".tower", n_img, w, h)
            f += tf
            if (wf, hf) != (w, h):
                f += 8.0 * q * c_tower
        vp = name + ".view_pool"
        f += _mlp_flops(shapes, vp + ".set_enc.mlp_elt_1", nv)
        f += _mlp_flops(shapes, vp + ".set_enc.mlp_set", n)
        f += _mlp_flops(shapes, vp + ".set_enc.mlp_elt_2", nv)
        f += _mlp_flops(shapes, vp + ".e_mod", nv)
        g, c = shapes[vp + ".e_score.weight"]
        f += 2.0 * nv * g * c
        f += 2.0 * nv * shapes[vp + ".e_mod.Dense_1.weight"][0]
    sub, down = graph.pair_counts()
    sizes = [c.shape[0] for c in graph.coords]

    def conv(key, pairs):
        _, cin, cout = shapes[key]
        return 2.0 * pairs * cin * cout

    def blocks(pre, lvl):
        out, b = 0.0, 0
        while f"{pre}.ResBlock_{b}.SparseConvNormRelu_0.SparseConv_0.weight" \
                in shapes:
            bp = f"{pre}.ResBlock_{b}"
            for k in (0, 1):
                out += conv(f"{bp}.SparseConvNormRelu_{k}.SparseConv_0.weight",
                            sub[lvl])
            if bp + ".Dense_0.weight" in shapes:
                o, c = shapes[bp + ".Dense_0.weight"]
                out += 2.0 * sizes[lvl] * o * c
            b += 1
        return out

    f += conv("stem.SparseConvNormRelu_0.SparseConv_0.weight", sub[0])
    n_down = len(sizes) - 1
    for i in range(n_down):
        f += conv(f"down{i}.SparseConvNormRelu_0.SparseConv_0.weight",
                  down[i])
        f += blocks(f"down{i}", i + 1)
    for j in range(n_down):
        lvl = n_down - 1 - j
        f += conv(f"up{j}.SparseConvNormRelu_0.SparseConv_0.weight",
                  down[lvl])
        f += blocks(f"up{j}", lvl)
    o, c = shapes["head.weight"]
    f += 2.0 * n * o * c
    return f


# --- byte bounds of the sorted-segment kernels -------------------------------
# One read of the live rows of x (inside [ptr[0], ptr[-1]) and valid), of the
# mask and of ptr; one write of the result.  The backward reads g at the
# segments that hold a live row (and, for max, x at the live rows and the
# forward's result at those segments) and writes gx once.

def _live_rows(ptr, valid, e):
    lo, hi = ptr[0].to(torch.int64), ptr[-1].to(torch.int64)
    if valid is None:
        return (hi - lo).to(torch.float64)
    r = torch.arange(e, device=ptr.device)
    return (valid & (r >= lo) & (r < hi)).sum().to(torch.float64)


def _live_segments(ptr, valid, e):
    v = (torch.ones(e, dtype=torch.int64, device=ptr.device) if valid is None
         else valid.to(torch.int64))
    cs = torch.cat([v.new_zeros(1), torch.cumsum(v, 0)])
    p = ptr.to(torch.int64).clamp(0, e)
    return ((cs[p[1:]] - cs[p[:-1]]) > 0).sum().to(torch.float64)


def segment_fwd_bytes(x, ptr, valid) -> torch.Tensor:
    e, c = x.shape
    s = ptr.numel() - 1
    return (_live_rows(ptr, valid, e) * c * 4 + (e if valid is not None else 0)
            + 4 * (s + 1) + s * c * 4)


def segment_bwd_bytes(g, x, ptr, valid, reduce, e) -> torch.Tensor:
    s, c = g.shape
    live_s = _live_segments(ptr, valid, e)
    b = (live_s * c * 4 + (e if valid is not None else 0) + 4 * (s + 1)
         + e * c * 4)
    if reduce == "max":
        b = b + _live_rows(ptr, valid, e) * c * 4 + live_s * c * 4
    return b
