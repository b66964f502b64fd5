"""Point Transformer V3 (the PTv3-m1 base model) in plain PyTorch.

The model of Wu et al. (CVPR 2024) as Pointcept's
``point_transformer_v3m1_base.py`` computes it, and its first training
steps under the S3DIS recipe, written out here from the equations with
nothing of the port imported:

* levels: level ``l + 1`` holds the distinct cells ``g >> 1`` of level
  ``l`` per sample (``torch.unique``); convolutions are sums of per-offset
  products scattered with ``index_add`` over pairs found by a sorted-key
  lookup (:mod:`.graph`), offsets in ``itertools.product`` order;
* serialization: Morton codes bit by bit (``z``, ``z-trans``: x and y
  swapped) and Hilbert codes by Pointcept's bit-array form of Skilling's
  transpose algorithm (``hilbert``, ``hilbert-trans``), the sample index
  above bit ``3 * depth``, ``depth`` the bit length of the largest level-0
  coordinate; coarse codes are the fine ones ``>> 3``;
* patches: each sample's points in an order cut into patches of ``K``, the
  last patch of a sample longer than ``K`` filled with the ``K - r`` points
  before it, a sample of ``K`` points or fewer one patch of its own length;
  ``softmax(q k^T / sqrt(16)) v`` written out per patch and head, in blocks
  of patches, each block recomputed in the backward (checkpointing) to fit
  the cell's size;
* the embedding, blocks, pooling (the maximum by ``scatter_reduce``),
  unpooling, BatchNorm (batch statistics, biased variance, eps 1e-3),
  LayerNorm (eps 1e-5), GELU and head as the port's docstring
  (``nn/ptv3.py``) and the source state them;
* loss: mean cross-entropy over the labelled points plus the Lovász-softmax
  over the classes present (Berman et al.), weight 1 each;
* optimizer: ``torch.optim.AdamW`` (lr 0.006, weight decay 0.05) with the
  parameters whose names hold ``block`` at a tenth of the rate, under
  ``torch.optim.lr_scheduler.OneCycleLR`` (pct_start 0.05, cosine, div 10,
  final div 1000, beta1 cycling 0.95 / 0.85), no clipping.

Taken from the program: the random draws alone (the permutation of the
four orders at level 0 and at each pooling, the DropPath keep masks per
point), each mapped onto this reference's own rows by the points'
coordinates.  The program's level rows follow from its batch (each coarse
row the parent cell of its pool head), which serves that mapping only.

Departures from the source, all stated: the precision is the
configuration's bfloat16 (Pointcept trains under float16 autocast);
``GridSample`` keeps one random point per cell at train time where the
port's cells average their points; the grid coordinates are each crop's
own (its minimum at 0) where the source keeps the room's; with no
generator (eval) the orders keep their stated sequence where the source
shuffles at test time too; the point count of a crop (102,400) is
Pointcept's ScanNet value.

Precision (:class:`Precision`): operands of the linear layers, the
attention and the sparse convolutions rounded to the stated format (their
outputs too where the program's come out in it: linear layers and the
attention), with the gradients on the way back; norms, pooling, losses and
accumulation in float32.  ``lower()`` is the control: float8 e4m3 with a
per-tensor scale for bfloat16.  :func:`train_steps` turns TF32 off.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .graph import _Lookup
from .model import _Round, _RoundGrad

__all__ = ["Precision", "Levels", "z_code", "hilbert_code",
           "codes", "forward", "loss_fn", "train_steps", "inputs_from_batch",
           "map_draws", "program_rows", "drop_rates", "param_groups"]

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")

_LOWER = {"f32": "bf16", "bf16": "fp8"}
_PATCH_BLOCK = 64          # patches per checkpointed attention block


class Precision:
    """The rounding of ``linear`` (the linear layers), ``attention`` (q, k,
    v and the output) and ``sparse`` (the sparse convolutions' operands):
    ``'f32'``, ``'bf16'`` or ``'fp8'``."""

    def __init__(self, kind: str = "bf16"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def lower(self) -> "Precision":
        return Precision(_LOWER[self.kind])

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kind == "f32" else _Round.apply(t, self.kind)

    def q_grad(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kind == "f32" else _RoundGrad.apply(t, self.kind)


# --- serialization ----------------------------------------------------------

def z_code(g: torch.Tensor, depth: int) -> torch.Tensor:
    """Morton codes of ``g [n, 3]`` (x the most significant of each
    triple)."""
    g = g.to(torch.int64)
    code = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    for i in range(depth):
        for a in range(3):
            code |= ((g[:, a] >> i) & 1) << (3 * i + 2 - a)
    return code


def hilbert_code(g: torch.Tensor, depth: int) -> torch.Tensor:
    """Hilbert codes of ``g [n, 3]`` at ``depth`` bits: the bits of each
    axis most significant first; for each bit and axis, where the axis's
    bit is set the lower bits of axis 0 are inverted, elsewhere the lower
    bits that differ between axis 0 and the axis are exchanged; the bits
    then read level by level (x, y, z) and Gray decoded."""
    g = g.to(torch.int64)
    shifts = torch.arange(depth - 1, -1, -1, device=g.device)
    bits = ((g[:, :, None] >> shifts) & 1).to(torch.bool)   # [n, 3, depth]
    for b in range(depth):
        for d in range(3):
            on = bits[:, d, b][:, None]
            low0 = bits[:, 0, b + 1:] ^ on
            flip = ~on & (low0 ^ bits[:, d, b + 1:])
            bits[:, 0, b + 1:] = low0 ^ flip
            bits[:, d, b + 1:] = bits[:, d, b + 1:] ^ flip
    stream = bits.transpose(1, 2).reshape(g.shape[0], 3 * depth)
    binary = torch.cumsum(stream.to(torch.int64), dim=1) % 2
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=g.device)
    return (binary * weights).sum(dim=1)


def codes(g: torch.Tensor, sample: torch.Tensor, depth: int,
          order: str) -> torch.Tensor:
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
    c = z_code(g, depth) if order.startswith("z") else hilbert_code(g, depth)
    return (sample.to(torch.int64) << (3 * depth)) | c


# --- levels and pairs -------------------------------------------------------

def _pairs(c: torch.Tensor, radius: int):
    """Submanifold pairs of rows ``c [n, 4]`` (sample, x, y, z) over the
    offsets ``(-radius .. radius)^3``."""
    look = _Lookup(c)
    rows = torch.arange(c.shape[0], device=c.device)
    out = []
    for off in itertools.product(range(-radius, radius + 1), repeat=3):
        q = c.clone()
        q[:, 1:] += torch.tensor(off, device=c.device)
        idx = look(q)
        hit = idx >= 0
        out.append((idx[hit], rows[hit]))
    return out


class Levels:
    """Per level ``l``: ``coords[l]`` (int64 ``[n_l, 4]``: sample and the
    cell ``g >> l``, sorted), ``pairs[l]`` (3^3 submanifold pairs),
    ``parent[l]`` (each row's cell at level ``l + 1``); ``stem`` the 5^3
    pairs of level 0 and ``depth`` the serialization depth."""

    def __init__(self, grid0: torch.Tensor, num_levels: int,
                 stem_kernel: int = 5):
        c0 = grid0.to(torch.int64)
        self.depth = max(int(c0[:, 1:].max()).bit_length(), 1)
        self.coords = [c0]
        self.parent = []
        for _ in range(num_levels - 1):
            c = self.coords[-1].clone()
            c[:, 1:] = c[:, 1:] >> 1
            nxt, inv = torch.unique(c, dim=0, return_inverse=True)
            self.parent.append(inv)
            self.coords.append(nxt)
        self.pairs = [_pairs(c, 1) for c in self.coords]
        self.stem = _pairs(c0, stem_kernel // 2)


# --- layers -----------------------------------------------------------------

def _lin(P, pre, x, prec, out_round=True):
    y = prec.q(x) @ prec.q(P[pre + ".weight"]).t()
    if pre + ".bias" in P:
        y = y + prec.q(P[pre + ".bias"])
    return prec.q(y) if out_round else y


def _sconv_core(x, w, pairs, n_out, kind):
    prec = Precision(kind)
    xq, wq = prec.q(x), prec.q(w)
    out = x.new_zeros(n_out, w.shape[2])
    for k, (i, o) in enumerate(pairs):
        if i.numel():
            out = out.index_add(0, o, xq[i] @ wq[k])
    return out


def _sconv(x, w, pairs, n_out, prec):
    out = checkpoint(_sconv_core, x, w, pairs, n_out, prec.kind,
                     use_reentrant=False)
    return prec.q_grad(out)


def _bn(P, pre, x):
    mean = x.mean(0)
    var = (x * x).mean(0) - mean * mean
    y = (x - mean) * torch.rsqrt(var.clamp(min=0.0) + 1e-3)
    return y * P[pre + ".weight"] + P[pre + ".bias"]


def _ln(P, pre, x):
    return F.layer_norm(x, (x.shape[1],), P[pre + ".weight"],
                        P[pre + ".bias"], 1e-5)


def _attend(q, k, v, scale):
    s = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    return s @ v


def _patch_index(counts: Sequence[int], patch: int, device, fill: bool):
    """Per sample: the positions (in the order) of its patches, ``[P, L]``
    rows, and the number of its real positions."""
    out, at = [], 0
    for c in counts:
        if c == 0:
            continue
        if c <= patch:
            out.append((torch.arange(at, at + c, device=device)[None], c))
        else:
            n = -(-c // patch)
            local = torch.arange(n * patch, device=device)
            if fill:
                local = torch.where(local < c, local, local - patch)
            else:
                # planted fault: the last patch left short
                local = torch.clamp(local, max=c - 1)
            out.append(((local + at).view(n, patch), c))
        at += c
    return out


def _attention(P, pre, x, lvl, order_row, heads, patch, prec, fill=True):
    c = x.shape[1]
    d = c // heads
    qkv = _lin(P, pre + ".qkv", x, prec)
    order = lvl["order"][order_row]
    per_sample = []
    for idx, real in _patch_index(lvl["counts"], patch, x.device, fill):
        p = idx.shape[0]
        if not fill and real > patch and real % patch:
            # the short last patch: its own length
            last = real - (p - 1) * patch
            parts = [idx[:-1], idx[-1:, :last]]
        else:
            parts = [idx]
        outs = []
        for part in parts:
            pp, ll = part.shape
            t = qkv[order[part.reshape(-1)]].view(pp, ll, 3, heads, d)
            q, k, v = prec.q(t).permute(2, 0, 3, 1, 4).unbind(0)
            blocks = []
            for s in range(0, pp, _PATCH_BLOCK):
                blocks.append(checkpoint(
                    _attend, q[s:s + _PATCH_BLOCK], k[s:s + _PATCH_BLOCK],
                    v[s:s + _PATCH_BLOCK], d ** -0.5, use_reentrant=False))
            o = torch.cat(blocks).transpose(1, 2).reshape(pp * ll, c)
            outs.append(o)
        per_sample.append(prec.q(torch.cat(outs))[:real])
    out_sorted = torch.cat(per_sample)
    return _lin(P, pre + ".proj", out_sorted[lvl["inverse"][order_row]],
                prec)


def _block(P, pre, x, lvl, index, heads, patch, rate, prec, keeps, faults):
    y = _sconv(x, P[pre + ".cpe.conv.weight"], lvl["pairs"], x.shape[0],
               prec) + P[pre + ".cpe.conv_bias"]
    x = x + _ln(P, pre + ".cpe.norm", _lin(P, pre + ".cpe.linear", y, prec))
    row = 0 if "order0" in faults else index % 4
    y = _attention(P, pre + ".attn", _ln(P, pre + ".norm1", x), lvl, row,
                   heads, patch, prec, fill="short_patch" not in faults)
    if (pre, "attn") in keeps:
        y = torch.where(keeps[(pre, "attn")][:, None], y / (1 - rate), 0.0)
    x = x + y
    h = F.gelu(_lin(P, pre + ".mlp.fc1", _ln(P, pre + ".norm2", x), prec))
    y = _lin(P, pre + ".mlp.fc2", h, prec)
    if (pre, "mlp") in keeps:
        y = torch.where(keeps[(pre, "mlp")][:, None], y / (1 - rate), 0.0)
    return x + y


def drop_rates(arch: Dict):
    """``(encoder rates per stage, decoder rates per stage)``: linspace(0,
    drop_path) over each half, reversed within each decoder stage."""
    def split(depths, total):
        r = torch.linspace(0, arch["drop_path"], total).tolist()
        out, at = [], 0
        for dd in depths:
            out.append(r[at:at + dd])
            at += dd
        return out

    enc = split(arch["enc_depths"], sum(arch["enc_depths"]))
    dec = split(arch["dec_depths"], sum(arch["dec_depths"]))
    return enc, [list(reversed(r)) for r in dec]


def _level_state(levels: Levels, l: int, code, rows):
    order = torch.argsort(code, dim=1)
    inverse = torch.empty_like(order)
    ar = torch.arange(order.shape[1], device=order.device)
    for r in range(order.shape[0]):
        inverse[r, order[r]] = ar
    sample = levels.coords[l][:, 0]
    counts = torch.bincount(sample, minlength=16).tolist()
    return {"code": code, "rows": rows, "order": order, "inverse": inverse,
            "counts": counts, "pairs": levels.pairs[l]}


def forward(P: Dict[str, torch.Tensor], inp: Dict, arch: Dict,
            prec: Precision, draws: Optional[Dict] = None,
            faults: Sequence[str] = ()) -> torch.Tensor:
    """Logits ``[n, classes]`` of the level-0 points of ``inp``
    (:func:`inputs_from_batch`) in train mode; ``draws``: ``{"perm":
    {level: [4 ints]}, "keep": {(block, sublayer): bool [n_level]}}``
    (reference rows), None for none drawn."""
    draws = draws or {"perm": {}, "keep": {}}
    levels: Levels = inp["levels"]
    perms, keeps = draws["perm"], draws["keep"]
    enc_dp, dec_dp = drop_rates(arch)
    depth = levels.depth
    c0 = levels.coords[0]
    rows = [ORDERS[i] for i in perms.get(0, range(4))]
    code = torch.stack([codes(c0[:, 1:], c0[:, 0], depth, o) for o in rows])
    states = [_level_state(levels, 0, code, rows)]
    x = _sconv(inp["feats"], P["stem.conv.weight"], levels.stem,
               c0.shape[0], prec)
    x = F.gelu(_bn(P, "stem.norm", x))
    skips = []
    for s, dd in enumerate(arch["enc_depths"]):
        if s > 0:
            skips.append(x)
            parent = levels.parent[s - 1]
            n_next = levels.coords[s].shape[0]
            y = _lin(P, f"enc.enc{s}.down.proj", x, prec, out_round=True)
            y = y.new_full((n_next, y.shape[1]), -torch.inf).scatter_reduce(
                0, parent[:, None].expand_as(y), y, "amax")
            x = F.gelu(_bn(P, f"enc.enc{s}.down.norm", y))
            prev = states[-1]
            code = torch.zeros((4, n_next), dtype=torch.int64,
                               device=x.device)
            code[:, parent] = prev["code"] >> 3
            perm = perms.get(s, range(4))
            code = code[list(perm)]
            rows = [prev["rows"][i] for i in perm]
            states.append(_level_state(levels, s, code, rows))
        for i in range(dd):
            x = _block(P, f"enc.enc{s}.block{i}", x, states[s], i,
                       arch["enc_num_head"][s], arch["enc_patch_size"][s],
                       enc_dp[s][i], prec, keeps, faults)
    for s in reversed(range(len(arch["dec_depths"]))):
        pre = f"dec.dec{s}.up"
        up = F.gelu(_bn(P, pre + ".norm", _lin(P, pre + ".proj", x, prec)))
        skip = F.gelu(_bn(P, pre + ".norm_skip",
                          _lin(P, pre + ".proj_skip", skips[s], prec)))
        x = skip + up[levels.parent[s]]
        for i in range(arch["dec_depths"][s]):
            x = _block(P, f"dec.dec{s}.block{i}", x, states[s], i,
                       arch["dec_num_head"][s], arch["dec_patch_size"][s],
                       dec_dp[s][i], prec, keeps, faults)
    return x @ P["head.weight"].t() + P["head.bias"]


# --- loss -------------------------------------------------------------------

def _lovasz(logits, labels):
    probs = torch.softmax(logits, dim=1)
    losses = []
    for c in range(logits.shape[1]):
        fg = (labels == c).to(torch.float32)
        if fg.sum() == 0:
            continue
        err = (fg - probs[:, c]).abs()
        err_s, perm = torch.sort(err, descending=True)
        fg_s = fg[perm]
        gts = fg_s.sum()
        inter = gts - fg_s.cumsum(0)
        union = gts + (1 - fg_s).cumsum(0)
        jac = 1.0 - inter / union
        jac = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append((err_s * jac).sum())
    if not losses:
        return logits.sum() * 0.0
    return torch.stack(losses).mean()


def loss_fn(logits, labels, lovasz: bool = True):
    """Mean cross-entropy over the labelled points (label >= 0), plus the
    Lovász-softmax over the classes present."""
    keep = labels >= 0
    lg, lb = logits[keep], labels[keep].to(torch.int64)
    loss = F.cross_entropy(lg, lb)
    return loss + _lovasz(lg, lb) if lovasz else loss


# --- training ---------------------------------------------------------------

def param_groups(names: List[str]):
    """``(names of the block parameters, the others)``."""
    block = [k for k in names if "block" in k]
    return block, [k for k in names if "block" not in k]


def train_steps(params: Dict[str, torch.Tensor], inputs: Sequence[Dict],
                arch: Dict, hp: Dict, prec: Precision,
                draws: Sequence[Optional[Dict]] = (),
                faults: Sequence[str] = ()) -> Dict:
    """Follow ``len(inputs)`` AdamW + one-cycle steps from ``params`` (left
    untouched); ``hp``: ``base_lr``, ``weight_decay``, ``total_steps``,
    ``block_lr_scale``.  Returns ``loss`` (per step), ``logits`` (the first
    step's), ``grad`` (per parameter, the first gradient) and ``delta``
    (per parameter, the change over the steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(params)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    block, other = param_groups(names)
    lr = hp["base_lr"]
    opt = torch.optim.AdamW(
        [{"params": [P[k] for k in other], "lr": lr},
         {"params": [P[k] for k in block], "lr": lr * hp["block_lr_scale"]}],
        lr=lr, weight_decay=hp["weight_decay"], foreach=False)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=[lr, lr * hp["block_lr_scale"]],
        total_steps=hp["total_steps"], pct_start=0.05,
        anneal_strategy="cos", div_factor=10.0, final_div_factor=1000.0)
    losses: List[float] = []
    first = logits0 = None
    for step, inp in enumerate(inputs):
        d = draws[step] if step < len(draws) else None
        logits = forward(P, inp, arch, prec, d, faults)
        if logits0 is None:
            logits0 = logits.detach()
        loss = loss_fn(logits, inp["labels"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: (torch.zeros_like(P[k]) if P[k].grad is None
                         else P[k].grad.detach().clone()) for k in names}
        opt.step()
        sched.step()
        del loss, logits
    delta = {k: (P[k].detach() - start[k]) for k in names}
    return {"loss": losses, "grad": first, "delta": delta,
            "logits": logits0}


# --- inputs -----------------------------------------------------------------

def _t(a, device, dtype=None):
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def program_rows(batch: Dict) -> List[torch.Tensor]:
    """The (sample, cell) of each valid row of each of the program's
    levels, from its host batch: level 0 from ``grid`` and ``batch_idx``,
    each coarser row the parent cell of its pool head."""
    g = batch["graph"]
    lv = g["levels"]
    n0 = int(sum(g["counts"][0]))
    rows = [torch.cat([torch.as_tensor(lv[0]["batch_idx"][:n0, None],
                                       dtype=torch.int64),
                       torch.as_tensor(g["grid"][:n0], dtype=torch.int64)],
                      1)]
    for l in range(1, len(lv)):
        n = int(sum(g["counts"][l]))
        head = torch.as_tensor(lv[l - 1]["pool_head"][:n], dtype=torch.int64)
        c = rows[-1][head].clone()
        c[:, 1:] = c[:, 1:] >> 1
        rows.append(c)
    return rows


def inputs_from_batch(batch: Dict, device, num_levels: int,
                      stem_kernel: int = 5) -> Dict:
    """The reference's inputs of a host PTv3 batch: the valid rows'
    features, labels and level-0 cells, the levels worked out from them,
    and the program's level rows (for the draws)."""
    g = batch["graph"]
    n0 = int(sum(g["counts"][0]))
    grid0 = torch.cat([
        _t(g["levels"][0]["batch_idx"][:n0, None], device, torch.int64),
        _t(g["grid"][:n0], device, torch.int64)], 1)
    return {"feats": _t(batch["feats"][:n0], device, torch.float32),
            "labels": _t(batch["labels"][:n0], device, torch.int64),
            "levels": Levels(grid0, num_levels, stem_kernel),
            "program_rows": [r.to(device) for r in program_rows(batch)]}


def map_draws(record: Sequence, inp: Dict) -> Dict:
    """The program's draws of one forward (``nn/ptv3.py``'s ``record``) on
    this reference's rows: each keep mask moved, level by level, from the
    program's rows to the reference's by coordinates."""
    levels: Levels = inp["levels"]
    looks = {}
    out = {"perm": {}, "keep": {}}
    for item in record:
        if item[0] == "perm":
            out["perm"][item[1]] = list(item[2])
            continue
        _, name, which, mask = item
        lvl = int(name.split(".")[1][3:])          # enc<s> / dec<s>: level s
        if lvl not in looks:
            prog = inp["program_rows"][lvl]
            at = _Lookup(levels.coords[lvl])(prog)
            if bool((at < 0).any()):
                raise ValueError(f"level {lvl}: a program row is not a "
                                 "reference cell")
            looks[lvl] = at
        at = looks[lvl]
        keep = torch.zeros(levels.coords[lvl].shape[0], dtype=torch.bool,
                           device=at.device)
        keep[at] = torch.as_tensor(mask[:at.numel()]).to(at.device)
        out["keep"][(name, which)] = keep
    return out
