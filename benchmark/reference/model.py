"""The multimodal segmentation model in plain PyTorch.

DeepViewAgg's early-fusion model as the configurations state it (the
upstream ``Res16UNet34-L4-early-*`` and ``Res16UNet34-PointPyramid-early-*``
entries): per image branch a deep-stem ResNet-18 tower with
weight-standardised convolutions and GroupNorm (16 groups, eps 1e-6),
truncated at a layer; the tower's maps sampled at each mapped pixel
(exactly at scale 1, else bilinear with border clamping at ``x / (W - 1) *
Wf - 0.5``); the per-view maximum over its pixels; the group attention view
pool (a DeepSet encoder of the 8 viewing-condition features, per-group
compatibilities, a softmax per point scaled by the square root of the view
count, a tanh(relu) gate on the largest compatibility); the pooled features
concatenated to the point features; a Res16UNet over the voxels with batch
norms over the voxels (eps 1e-5) and a linear head; a mean cross-entropy
over the labelled voxels.

Parameters come as a dict keyed by the port's parameter names (the
checkpoint format both sides share); everything else, the voxel levels and
the convolution pairs included, is worked out here from the inputs.  Sparse
convolutions are sums of per-offset products scattered with ``index_add``,
segment reductions are ``scatter_reduce`` / ``index_add``.  No module of the
port is imported.

One detail is the program's, not the model's, and is followed here as an
input (``set_rows``): the port's set encoder takes its second MLP's
batch-norm statistics over ``cap0`` point rows with a flat image batch,
``cap0 + 1`` with camera-family buckets, where ``cap0`` is the batch's
voxel capacity, so that rows past the real voxels, which hold the encoding
of a point that no view sees, weigh in the statistics and the result
depends on the bucket's capacity (which each cell pins).  The pixel and
view tables are the loader's output and are inputs too; the voxel levels
and convolution pairs are worked out here.

The arithmetic follows the precision the configuration states
(:class:`Precision`): for the recipes bfloat16 operands and activations in
the towers, bfloat16-rounded operands and cotangents in the sparse
convolutions, float32 elsewhere.  ``Precision.lower()`` puts one step less
in those places (float8 e4m3 with a per-tensor scale for bfloat16): the
control of the comparison that decides ``correct``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .graph import build_graph

__all__ = ["Precision", "forward", "loss_fn", "inputs_from_batch",
           "NUM_LEVELS"]

NUM_LEVELS = 5
_FP8_MAX = 448.0


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to ``kind``: bfloat16, or float8 e4m3 with a
    per-tensor scale (its largest magnitude at the format's largest)."""
    if kind == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    amax = t.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    s = amax / _FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Round(torch.autograd.Function):
    """Rounds the value, and its gradient on the way back."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _round(t, kind)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


class _RoundGrad(torch.autograd.Function):
    """The identity, rounding the gradient on the way back."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


_LOWER = {"f32": "bf16", "bf16": "fp8"}


class Precision:
    """The rounding of the two parts where the configuration states a
    precision: ``tower`` (the towers' convolution operands and
    activations) and ``sparse`` (the sparse convolutions' operands and
    cotangents), each ``'f32'`` (no rounding), ``'bf16'`` or ``'fp8'``
    (float8 e4m3, per-tensor scales).  Norms, reductions, the view pool,
    the head and every accumulation stay float32.  ``lower()`` is the
    control's: one step below each."""

    def __init__(self, tower: str = "bf16", sparse: str = "bf16"):
        for kind in (tower, sparse):
            if kind not in ("f32", "bf16", "fp8"):
                raise ValueError(kind)
        self.kinds = {"tower": tower, "sparse": sparse}

    def lower(self) -> "Precision":
        return Precision(**{k: _LOWER[v] for k, v in self.kinds.items()})

    def q(self, t: torch.Tensor, part: str) -> torch.Tensor:
        kind = self.kinds[part]
        return t if kind == "f32" else _Round.apply(t, kind)

    def q_grad(self, t: torch.Tensor, part: str) -> torch.Tensor:
        kind = self.kinds[part]
        return t if kind == "f32" else _RoundGrad.apply(t, kind)


# --- plain layers ----------------------------------------------------------

def _bn(P, pre, x, train):
    if train:
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
    else:
        mean, var = P[pre + ".running_mean"], P[pre + ".running_var"]
    return (x - mean) * torch.rsqrt(var + 1e-5) * P[pre + ".weight"] \
        + P[pre + ".bias"]


def _mlp(P, pre, x, train):
    i = 0
    while f"{pre}.Dense_{i}.weight" in P:
        x = x @ P[f"{pre}.Dense_{i}.weight"].t()
        x = F.leaky_relu(_bn(P, f"{pre}.MaskedBatchNorm_{i}", x, train), 0.2)
        i += 1
    return x


def _seg_max(x, ids, n):
    """Per segment and channel the largest element (0 for an empty
    segment); its gradient goes to the first row that attains it, as the
    upstream's ``torch_scatter`` maximum routes it."""
    e = x.shape[0]
    if e == 0:
        return x.new_zeros((n,) + x.shape[1:])
    idx = ids[:, None].expand_as(x)
    with torch.no_grad():
        top = x.new_zeros((n,) + x.shape[1:]).scatter_reduce(
            0, idx, x, "amax", include_self=False)
        rows = torch.arange(e, device=x.device)[:, None].expand_as(x)
        cand = torch.where(x == top[ids], rows, e)
        arg = torch.full((n,) + x.shape[1:], e, dtype=torch.int64,
                         device=x.device).scatter_reduce(
            0, idx, cand, "amin", include_self=True)
        hit = arg < e
    out = torch.gather(x, 0, arg.clamp(max=max(e - 1, 0)))
    return torch.where(hit, out, torch.zeros_like(out))


def _seg_sum(x, ids, n):
    return x.new_zeros((n,) + x.shape[1:]).index_add(0, ids, x)


def _group_sizes(c, g):
    base, rem = divmod(c, g)
    return [base + (1 if i < rem else 0) for i in range(g)]


def _expand(x, c):
    g = x.shape[1]
    return torch.repeat_interleave(
        x, torch.tensor(_group_sizes(c, g), device=x.device), dim=1)


# --- 2D tower ---------------------------------------------------------------

def _ws_conv(x, w, stride, prec):
    fan = w[0].numel()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    w = (w - mean) / torch.sqrt(var * fan + 1e-10)
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    return prec.q(F.conv2d(prec.q(x, "tower"), prec.q(w, "tower"),
                           stride=stride, padding=pad), "tower")


def _gn(P, pre, x, prec):
    w = P[pre + ".weight"]
    g = 16
    while x.shape[1] % g:
        g -= 1
    return prec.q(F.group_norm(x, g, w, P[pre + ".bias"], eps=1e-6), "tower")


def tower(P, pre, images, prec):
    """``images [I, W, H, 3]`` -> maps ``[I, Wf, Hf, C]``: the stem's
    convolutions (stride 2, then 1), a 3 x 3 max pool of stride 2, then
    basic blocks in pairs, the first of each pair past the first layer of
    stride 2."""
    x = prec.q(images.permute(0, 3, 1, 2), "tower")
    i = 0
    while f"{pre}.Conv2dWS_{i}.weight" in P:
        x = F.relu(_gn(P, f"{pre}._Norm_{i}.GroupNorm_0", _ws_conv(
            x, P[f"{pre}.Conv2dWS_{i}.weight"], 2 if i == 0 else 1, prec),
            prec))
        i += 1
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    b = 0
    while f"{pre}._BasicBlock2d_{b}.Conv2dWS_0.weight" in P:
        bp = f"{pre}._BasicBlock2d_{b}"
        stride = 2 if (b >= 2 and b % 2 == 0) else 1
        y = F.relu(_gn(P, bp + "._Norm_0.GroupNorm_0", _ws_conv(
            x, P[bp + ".Conv2dWS_0.weight"], stride, prec), prec))
        y = _gn(P, bp + "._Norm_1.GroupNorm_0", _ws_conv(
            y, P[bp + ".Conv2dWS_1.weight"], 1, prec), prec)
        if bp + ".Conv2dWS_2.weight" in P:
            x = _gn(P, bp + "._Norm_2.GroupNorm_0", _ws_conv(
                x, P[bp + ".Conv2dWS_2.weight"], stride, prec), prec)
        x = F.relu(prec.q(y + x, "tower"))
        b += 1
    return x.permute(0, 2, 3, 1)


def _sample(maps, img, px, py, w, h):
    """Features of the maps at pixel ``(px, py)`` of an image of size
    ``(w, h)``."""
    _, wf, hf, _ = maps.shape
    if (wf, hf) == (w, h):
        return maps[img, px, py]
    xf = px.to(torch.float32) / max(w - 1, 1) * wf - 0.5
    yf = py.to(torch.float32) / max(h - 1, 1) * hf - 0.5
    x0, y0 = torch.floor(xf), torch.floor(yf)
    tx, ty = (xf - x0)[:, None], (yf - y0)[:, None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def tap(xi, yi):
        return maps[img, xi.clamp(0, wf - 1), yi.clamp(0, hf - 1)]

    return (tap(x0, y0) * (1 - tx) * (1 - ty) + tap(x0 + 1, y0) * tx * (1 - ty)
            + tap(x0, y0 + 1) * (1 - tx) * ty + tap(x0 + 1, y0 + 1) * tx * ty)


def branch(P, pre, inp, num_groups, train, prec):
    """The pooled image features of one branch, ``[n, C]``."""
    views = inp["views"]
    nv, n = views["point_id"].shape[0], inp["feats"].shape[0]
    c_tower = P[pre + ".view_pool.e_mod.Dense_0.weight"].shape[1]
    x_view = inp["feats"].new_zeros(nv, c_tower)
    for bk in inp["buckets"]:
        if bk["pix_view"].numel() == 0:
            continue
        maps = tower(P, pre + ".tower", bk["images"], prec)
        w, h = bk["images"].shape[1], bk["images"].shape[2]
        pix = _sample(maps, bk["pix_image"], bk["pix_x"], bk["pix_y"], w, h)
        x_view = x_view + _seg_max(pix, bk["pix_view"], nv)
    pid = views["point_id"]
    cnt = torch.bincount(pid, minlength=n).to(torch.float32)
    vp = pre + ".view_pool"
    e1 = _mlp(P, vp + ".set_enc.mlp_elt_1", views["view_feats"], train)
    xs = torch.cat([_seg_max(e1, pid, n),
                    torch.sqrt(1.0 / (cnt + 1e-3))[:, None]], 1)
    extra = inp["set_rows"] - n
    if extra > 0:
        empty = torch.cat([xs.new_zeros(e1.shape[1]),
                           xs.new_full((1,), (1.0 / 1e-3) ** 0.5)])
        xs = torch.cat([xs, empty.expand(extra, -1)])
    xs = _mlp(P, vp + ".set_enc.mlp_set", xs, train)[:n]
    enc = _mlp(P, vp + ".set_enc.mlp_elt_2",
               torch.cat([e1, xs[pid]], 1), train)
    values = _mlp(P, vp + ".e_mod", x_view, train)
    compat = enc @ P[vp + ".e_score.weight"].t() + P[vp + ".e_score.bias"]
    cmax = _seg_max(compat, pid, n)
    shifted = (compat - cmax.detach()[pid]) \
        / torch.sqrt(torch.clamp(cnt, min=1.0))[pid][:, None]
    e = torch.exp(shifted)
    attn = e / (_seg_sum(e, pid, n)[pid] + 1e-12)
    c = values.shape[1]
    pooled = _seg_sum(values * _expand(attn, c), pid, n)
    gate = torch.tanh(F.relu(cmax * P[vp + ".gating.weight"]
                             + P[vp + ".gating.bias"]))
    assert gate.shape[1] == num_groups
    return pooled * _expand(gate, c)


# --- sparse UNet ---------------------------------------------------------------

def _sconv(x, w, pairs, n_out, prec):
    out = x.new_zeros(n_out, w.shape[2])
    xq, wq = prec.q(x, "sparse"), prec.q(w, "sparse")
    for k, (i, o) in enumerate(pairs):
        if i.numel():
            out = out.index_add(0, o, xq[i] @ wq[k])
    return prec.q_grad(out, "sparse")


def _cnr(P, pre, x, pairs, n_out, train, prec, relu=True):
    y = _bn(P, pre + ".MaskedBatchNorm_0",
            _sconv(x, P[pre + ".SparseConv_0.weight"], pairs, n_out, prec),
            train)
    return F.relu(y) if relu else y


def _blocks(P, pre, x, pairs, n, train, prec):
    b = 0
    while f"{pre}.ResBlock_{b}.SparseConvNormRelu_0.SparseConv_0.weight" in P:
        bp = f"{pre}.ResBlock_{b}"
        y = _cnr(P, bp + ".SparseConvNormRelu_0", x, pairs, n, train, prec)
        y = _cnr(P, bp + ".SparseConvNormRelu_1", y, pairs, n, train, prec,
                 relu=False)
        if bp + ".Dense_0.weight" in P:
            x = _bn(P, bp + ".MaskedBatchNorm_0",
                    x @ P[bp + ".Dense_0.weight"].t(), train)
        x = F.relu(y + x)
        b += 1
    return x


def branch_names(P) -> List[str]:
    """The level-0 branches in the order the model fuses them."""
    names, k = [], 0
    while True:
        name = "branch_l0" if k == 0 else f"branch_l0_{k}"
        if name + ".view_pool.e_score.weight" not in P:
            return names
        names.append(name)
        k += 1


def forward(P: Dict[str, torch.Tensor], inp: Dict, num_groups: int,
            train: bool, prec: Optional[Precision] = None) -> torch.Tensor:
    """Logits ``[n, classes]`` of the ``n`` voxels of ``inp``."""
    prec = prec or Precision()
    g = inp.get("graph")
    if g is None:
        g = inp["graph"] = build_graph(inp["coords"], NUM_LEVELS)
    sizes = [c.shape[0] for c in g.coords]
    x = inp["feats"]
    for name in branch_names(P):
        x = torch.cat([x, branch(P, name, inp, num_groups, train, prec)], 1)
    x = _cnr(P, "stem.SparseConvNormRelu_0", x, g.sub[0], sizes[0], train,
             prec)
    n_down = NUM_LEVELS - 1
    skips = [x]
    for i in range(n_down):
        x = _cnr(P, f"down{i}.SparseConvNormRelu_0", x, g.down[i],
                 sizes[i + 1], train, prec)
        x = _blocks(P, f"down{i}", x, g.sub[i + 1], sizes[i + 1], train, prec)
        if i < n_down - 1:
            skips.append(x)
    for j in range(n_down):
        lvl = n_down - 1 - j
        up_pairs = [(o, i) for i, o in g.down[lvl]]
        x = _cnr(P, f"up{j}.SparseConvNormRelu_0", x, up_pairs, sizes[lvl],
                 train, prec)
        x = torch.cat([x, skips[lvl]], 1)
        x = _blocks(P, f"up{j}", x, g.sub[lvl], sizes[lvl], train, prec)
    return x @ P["head.weight"].t() + P["head.bias"]


def loss_fn(logits, labels):
    """Mean cross-entropy over the voxels whose label is not -1."""
    return F.cross_entropy(logits, labels, ignore_index=-1)


# --- inputs -----------------------------------------------------------------------

def _t(a, device, dtype=None):
    t = torch.as_tensor(a).to(device)
    return t if dtype is None else t.to(dtype)


def inputs_from_batch(batch: Dict, coords, device) -> Dict:
    """The reference's inputs from a collated host batch (numpy arrays in
    the batch layout both sides read) and the level-0 voxel coordinates
    ``coords [n, 4]`` (sample, x, y, z) of its ``n`` real voxels: the point
    features and labels, the view table and per image batch the images and
    the pixel table, with padding left out."""
    n = int(len(coords))
    feats = _t(batch["feats"][:n], device, torch.float32)
    labels = _t(batch["labels"][:n], device, torch.int64)
    mm = batch["mappings"][0]
    if "buckets" in mm:
        view, ladder = mm["view"], True
        tables = [(batch["bucket_images"][b], bk, bk["pix_image"])
                  for b, bk in enumerate(mm["buckets"])]
    else:
        view, ladder = mm, False
        vcap = len(mm["view_valid"])
        img = mm["image_id"][mm["pix_view"].clip(max=vcap - 1)]
        tables = [(batch["images"], mm, img)]
    vvalid = view["view_valid"].astype(bool)
    keep = vvalid.nonzero()[0]
    remap = -torch.ones(len(vvalid), dtype=torch.int64)
    remap[torch.as_tensor(keep)] = torch.arange(len(keep))
    views = {"point_id": _t(view["point_id"][keep], device, torch.int64),
             "view_feats": _t(view["view_feats"][keep], device,
                              torch.float32)}
    buckets = []
    for images, tab, img in tables:
        pv = tab["pix_view"].astype("int64")
        ok = tab["pix_valid"].astype(bool) & (pv < len(vvalid))
        ok[ok] &= vvalid[pv[ok]]
        sel = ok.nonzero()[0]
        buckets.append({
            "images": _t(images, device, torch.float32),
            "pix_view": remap[torch.as_tensor(pv[sel])].to(device),
            "pix_image": _t(img[sel], device, torch.int64),
            "pix_x": _t(tab["pix_x"][sel], device, torch.int64),
            "pix_y": _t(tab["pix_y"][sel], device, torch.int64)})
    cap0 = len(batch["feats"])
    return {"coords": _t(coords, device, torch.int64), "feats": feats,
            "labels": labels, "views": views, "buckets": buckets,
            "set_rows": cap0 + 1 if ladder else cap0}
