"""Point Transformer V2 (the PT-v2m2 base model) in plain PyTorch.

The model of Wu, Lao, Jiang, Liu and Zhao (NeurIPS 2022) as Pointcept's
``point_transformer_v2m2_base.py`` computes it, and its first training
steps under the S3DIS recipe, written out here from the equations with
nothing of the port imported:

* neighbours: for each level, the brute force over each sample's points in
  chunks of queries: squared distances ``dx*dx + dy*dy + dz*dz`` (``d = p_j
  - p_i``, each step rounded to float32), the ``k`` smallest by (distance,
  row) through one ``topk`` over the distance's bits above the row's; -1
  past a sample's size (:func:`knn`);
* grouping as ``pointops.grouping``: a zero row appended for the missing
  neighbour (-1), relative positions ``p_j - p_i`` multiplied by ``sign(idx
  + 1)``;
* grid pooling: each sample's cells ``floor((p - lo) / grid)`` from its
  minimum corner, clusters by ``torch.unique`` over (sample, z, y, x),
  features by ``scatter_reduce`` (``amax``; the cotangent goes whole to
  every row that attains the maximum, the port's convention, where
  Pointcept's ``torch_scatter`` picks one), positions averaged in float64;
  unpooling by the clusters' inverse;
* grouped vector attention, blocks, the patch embedding and the head as the
  port's docstring (``nn/ptv2.py``) and the source state them; BatchNorm
  from the rows' mean and biased variance (eps 1e-5) over every row of
  ``[N, C]`` or ``[N, S, C]``;
* loss: mean cross-entropy over the labelled points;
* optimizer: ``torch.optim.AdamW`` (lr 0.006, weight decay 0.05) under
  ``torch.optim.lr_scheduler.MultiStepLR`` (gamma 0.1 at the recipe's
  milestones), no clipping.

Each block is recomputed in the backward pass (checkpointing), so that the
largest level's neighbour tensors of one block alone are held at a time:
at the cell's size the reference runs after the program has let go of
the card.

Taken from the program: the DropPath keep masks alone, a mask over each
level's rows.  Both order a level's rows by (sample, z, y, x) of the
pooling's cells, so the masks need no mapping; :func:`map_draws` checks
that the program's level sizes are the reference's.

Departures from the source, all stated: the precision is the
configuration's bfloat16 (Pointcept trains under float16 autocast);
``GridSample`` keeps one point per 2 cm cell where the port's cached cells
average their points; the positions are the rooms' where the source
centres each crop; the point count of a crop (102,400) is the PTv3
cell's, where the S3DIS file is believed to crop at 80,000.

Precision (:class:`.ptv3.Precision`): operands and outputs of the linear
layers of the blocks, the attention, pooling and unpooling rounded to the
stated format, with the gradients on the way back; BatchNorm statistics,
the softmax, the weighted sum, pooling, the residual, head, loss and
accumulation in float32.  ``lower()`` is the control: float8 e4m3 with a
per-tensor scale for bfloat16.  :func:`train_steps` turns TF32 off.

Planted faults (``faults``) for the calibration of the cell's limits:
``cross_sample`` (neighbours searched over the whole batch, across
samples), ``no_peb_value`` (the positional bias left out of the value
path), ``no_mask`` (the mask not applied after the softmax),
``no_pool_grad`` (no cotangent through the grid pooling's maximum, as a
segment maximum whose backward returns zeros) and ``frozen`` (the
optimizer's steps leave the parameters as they are: learning rate 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ptv3 import Precision

__all__ = ["Precision", "knn", "Levels", "forward", "loss_fn", "train_steps",
           "inputs_from_batch", "map_draws", "drop_rates"]

_PAIRS = 1 << 28          # query-point pairs a chunk of the brute force


# --- neighbours -------------------------------------------------------------

def knn(pos: torch.Tensor, sample: torch.Tensor, k: int,
        cross_sample: bool = False):
    """``(idx int64 [n, k], d2 f32 [n, k])``: each row's ``k`` nearest rows
    of its own sample (of all rows with ``cross_sample``), by (squared
    distance, row); -1 and +inf past a sample's size."""
    n = pos.shape[0]
    idx = torch.full((n, k), -1, dtype=torch.int64, device=pos.device)
    d2 = torch.full((n, k), float("inf"), device=pos.device)
    if n == 0:
        return idx, d2
    groups = [torch.arange(n, device=pos.device)] if cross_sample else [
        torch.nonzero(sample == b)[:, 0]
        for b in torch.unique(sample).tolist()]
    for rows in groups:
        pts = pos[rows]
        kk = min(k, rows.numel())
        chunk = max(1, _PAIRS // rows.numel())
        for s in range(0, rows.numel(), chunk):
            q = pts[s:s + chunk]
            d = pts[None, :, :] - q[:, None, :]
            dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            key = (dist.view(torch.int32).to(torch.int64) << 32) \
                | rows[None, :]
            top = torch.topk(key, kk, dim=1, largest=False, sorted=True)[0]
            at = rows[s:s + chunk]
            idx[at, :kk] = top & 0xFFFFFFFF
            d2[at, :kk] = (top >> 32).to(torch.int32).view(torch.float32)
    return idx, d2


def _tables(idx: torch.Tensor, pos: torch.Tensor, k: int):
    """``(zero-row index [n, k], mask [n, k], relative positions [n, k,
    3])`` of the first ``k`` columns of a table, as ``pointops.grouping``
    groups them."""
    n = pos.shape[0]
    t = idx[:, :k]
    mask = (t >= 0).to(torch.float32)
    z = torch.where(t >= 0, t, n)
    padded = torch.cat([pos, pos.new_zeros(1, 3)])
    rel = (padded[z] - pos[:, None, :]) * mask[..., None]
    return z, mask, rel


# --- levels -----------------------------------------------------------------

class Levels:
    """Per level ``l``: ``pos[l]`` (float32 ``[n_l, 3]``), ``sample[l]``,
    ``counts[l]`` (points a sample), ``cluster[l]`` (each row's cluster at
    level ``l + 1``) and ``knn[l]`` (the widest table the level needs;
    none without ``search``)."""

    def __init__(self, pos: torch.Tensor, sample: torch.Tensor, nb: int,
                 arch: Dict, faults: Sequence[str] = (),
                 search: bool = True):
        self.pos, self.sample, self.cluster = [pos], [sample], []
        for grid in arch["grid_sizes"]:
            p, s = self.pos[-1], self.sample[-1]
            lo = torch.stack([p[s == b].amin(0) if bool((s == b).any())
                              else p.new_zeros(3) for b in range(nb)])
            g = torch.tensor(grid, dtype=torch.float32, device=p.device)
            cell = torch.floor((p - lo[s]) / g).to(torch.int64)
            key = torch.stack([s, cell[:, 2], cell[:, 1], cell[:, 0]], 1)
            uniq, inv, cnt = torch.unique(key, dim=0, return_inverse=True,
                                          return_counts=True)
            mean = torch.zeros((uniq.shape[0], 3), dtype=torch.float64,
                               device=p.device)
            mean.index_add_(0, inv, p.to(torch.float64))
            self.cluster.append(inv)
            self.pos.append((mean / cnt[:, None]).to(torch.float32))
            self.sample.append(uniq[:, 0])
        self.counts = [torch.bincount(s, minlength=nb).tolist()
                       for s in self.sample]
        self.knn = []
        for lvl, (p, s) in enumerate(zip(self.pos, self.sample)):
            if not search:
                break
            k = max(_level_ks(arch, lvl))
            self.knn.append(knn(p, s, k, "cross_sample" in faults))


def _level_ks(arch: Dict, lvl: int) -> List[int]:
    ks = [arch["patch_embed_neighbours"]] if lvl == 0 else \
        [arch["enc_neighbours"][lvl - 1]]
    if lvl < len(arch["dec_depths"]):
        ks.append(arch["dec_neighbours"][lvl])
    return ks


# --- layers -----------------------------------------------------------------

def _lin(P, pre, x, prec, out_round=True):
    y = prec.q(x) @ prec.q(P[pre + ".weight"]).t()
    if pre + ".bias" in P:
        y = y + prec.q(P[pre + ".bias"])
    return prec.q(y) if out_round else y


def _bn(P, pre, x):
    rows = tuple(range(x.ndim - 1))
    mean = x.mean(rows)
    var = (x * x).mean(rows) - mean * mean
    a = P[pre + ".weight"] * torch.rsqrt(var.clamp(min=0.0) + 1e-5)
    return x * a + (P[pre + ".bias"] - mean * a)


def _attention(P, pre, x, tab, groups, prec, faults):
    z, mask, rel = tab
    n, s = z.shape
    c = x.shape[1]
    q = F.relu(_bn(P, pre + ".q_norm", _lin(P, pre + ".q", x, prec)))
    k = F.relu(_bn(P, pre + ".k_norm", _lin(P, pre + ".k", x, prec)))
    v = _lin(P, pre + ".v", x, prec)
    kj = torch.cat([k, k.new_zeros(1, c)])[z]
    vj = torch.cat([v, v.new_zeros(1, c)])[z]
    pe = F.relu(_bn(P, pre + ".pe_norm", _lin(P, pre + ".pe1", rel, prec)))
    peb = _lin(P, pre + ".pe2", pe, prec)
    r = kj - q[:, None, :] + peb
    w = F.relu(_bn(P, pre + ".we_norm", _lin(P, pre + ".we1", r, prec)))
    w = torch.softmax(_lin(P, pre + ".we2", w, prec), dim=1)
    if "no_mask" not in faults:
        w = w * mask[..., None]
    value = vj if "no_peb_value" in faults else vj + peb
    out = value.view(n, s, groups, c // groups) * w[..., None]
    return out.sum(1).reshape(n, c)


def _block(P, pre, x, tab, groups, rate, keep, prec, faults):
    h = F.relu(_bn(P, pre + ".norm1", _lin(P, pre + ".fc1", x, prec)))
    h = _attention(P, pre + ".attn", h, tab, groups, prec, faults)
    h = F.relu(_bn(P, pre + ".norm2", h))
    h = _bn(P, pre + ".norm3", _lin(P, pre + ".fc3", h, prec))
    if keep is not None:
        h = torch.where(keep[:, None], h / (1.0 - rate), 0.0)
    return F.relu(x + h)


def _sequence(P, pre, x, tab, groups, rates, keeps, prec, faults):
    for i, rate in enumerate(rates):
        name = f"{pre}.block{i}"
        keep = keeps.get(name)
        params = {k: v for k, v in P.items() if k.startswith(name + ".")}
        x = checkpoint(_block, params, name, x, tab, groups, rate, keep,
                       prec, faults, use_reentrant=False)
    return x


def _cluster_max(y, inv, n_next, no_grad: bool = False):
    """Each cluster's maximum of ``y``; its cotangent goes whole to every
    row that attains it (ties included), the convention of the port's
    segment reductions (``ops/segment.py``) and of the JAX package
    (``no_grad``: to none, the fault ``no_pool_grad``)."""
    idx = inv[:, None].expand_as(y)
    top = y.new_full((n_next, y.shape[1]), -torch.inf).scatter_reduce(
        0, idx, y.detach(), "amax")
    if no_grad:
        return top
    hit = y.detach() == top[inv]
    return top + torch.zeros_like(top).index_add(
        0, inv, torch.where(hit, y - y.detach(), 0.0))


def drop_rates(arch: Dict):
    """``(encoder rates per stage, decoder rates per stage)``: linspace(0,
    drop_path) over each, stage 0 first."""
    def split(depths):
        r = torch.linspace(0, arch["drop_path"], sum(depths)).tolist()
        out, at = [], 0
        for d in depths:
            out.append(r[at:at + d])
            at += d
        return out

    return split(arch["enc_depths"]), split(arch["dec_depths"])


def forward(P: Dict[str, torch.Tensor], inp: Dict, arch: Dict,
            prec: Precision, draws: Optional[Dict] = None,
            faults: Sequence[str] = ()) -> torch.Tensor:
    """Logits ``[n, classes]`` of the points of ``inp``
    (:func:`inputs_from_batch`) in train mode; ``draws``: ``{"keep":
    {block name: bool [n_level]}}``, None for none drawn."""
    keeps = (draws or {}).get("keep", {})
    lv: Levels = inp["levels"]
    enc_dp, dec_dp = drop_rates(arch)

    def tab(lvl, k):
        return _tables(lv.knn[lvl][0], lv.pos[lvl], k)

    x = F.relu(_bn(P, "stem.norm", _lin(P, "stem.proj", inp["feats"],
                                        prec)))
    x = _sequence(P, "stem.blocks", x, tab(0, arch["patch_embed_neighbours"]),
                  arch["patch_embed_groups"],
                  [0.0] * arch["patch_embed_depth"], keeps, prec, faults)
    skips = []
    for s, depth in enumerate(arch["enc_depths"]):
        pre = f"enc.enc{s}"
        skips.append(x)
        y = F.relu(_bn(P, pre + ".down.norm",
                       _lin(P, pre + ".down.fc", x, prec)))
        x = _cluster_max(y, lv.cluster[s], lv.pos[s + 1].shape[0],
                         "no_pool_grad" in faults)
        x = _sequence(P, pre + ".blocks", x,
                      tab(s + 1, arch["enc_neighbours"][s]),
                      arch["enc_groups"][s], enc_dp[s], keeps, prec, faults)
    for s in reversed(range(len(arch["dec_depths"]))):
        pre = f"dec.dec{s}"
        up = F.relu(_bn(P, pre + ".up.norm", _lin(P, pre + ".up.proj", x,
                                                  prec)))
        skip = F.relu(_bn(P, pre + ".up.norm_skip",
                          _lin(P, pre + ".up.proj_skip", skips[s], prec)))
        x = skip + up[lv.cluster[s]]
        x = _sequence(P, pre + ".blocks", x,
                      tab(s, arch["dec_neighbours"][s]),
                      arch["dec_groups"][s], dec_dp[s], keeps, prec, faults)
    h = x @ P["head.fc1.weight"].t() + P["head.fc1.bias"]
    h = F.relu(_bn(P, "head.norm", h))
    return h @ P["head.fc2.weight"].t() + P["head.fc2.bias"]


# --- loss and training ------------------------------------------------------

def loss_fn(logits, labels):
    """Mean cross-entropy over the labelled points (label >= 0)."""
    keep = labels >= 0
    return F.cross_entropy(logits[keep], labels[keep].to(torch.int64))


def train_steps(params: Dict[str, torch.Tensor], inputs: Sequence[Dict],
                arch: Dict, hp: Dict, prec: Precision,
                draws: Sequence[Optional[Dict]] = (),
                faults: Sequence[str] = ()) -> Dict:
    """Follow ``len(inputs)`` AdamW + MultiStepLR steps from ``params``
    (left untouched); ``hp``: ``base_lr``, ``weight_decay``,
    ``lr_milestones``, ``lr_gamma``.  Returns ``loss`` (per step),
    ``logits`` (the first step's), ``grad`` (per parameter, the first
    gradient) and ``delta`` (per parameter, the change over the steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(params)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    lr = 0.0 if "frozen" in faults else hp["base_lr"]
    opt = torch.optim.AdamW([P[k] for k in names], lr=lr,
                            weight_decay=hp["weight_decay"], foreach=False)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=list(hp["lr_milestones"]), gamma=hp["lr_gamma"])
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

def inputs_from_batch(batch: Dict, device, arch: Dict,
                      faults: Sequence[str] = (), search: bool = True) -> Dict:
    """The reference's inputs of a host PTv2 batch: the real rows'
    features, labels, positions and samples, and the levels, clusters and
    (with ``search``) neighbour tables worked out from them."""
    counts = [int(c) for c in batch["graph"]["counts"][0]]
    n0 = sum(counts)
    sample = torch.as_tensor(
        batch["graph"]["levels"][0]["batch_idx"][:n0]).to(device,
                                                         torch.int64)
    pos = torch.as_tensor(batch["pos"][:n0]).to(device, torch.float32)
    with torch.no_grad():
        levels = Levels(pos, sample, len(counts), arch, faults, search)
    return {"feats": torch.as_tensor(batch["feats"][:n0]).to(
                device, torch.float32),
            "labels": torch.as_tensor(batch["labels"][:n0]).to(
                device, torch.int64),
            "levels": levels}


def map_draws(record: Sequence, inp: Dict) -> Dict:
    """The program's DropPath masks of one forward (``nn/ptv2.py``'s
    ``record``), on this reference's rows: the same rows, once the
    program's level sizes are checked against the reference's."""
    lv: Levels = inp["levels"]
    out = {"keep": {}}
    for item in record:
        if item[0] == "level":
            _, lvl, counts = item
            if list(counts) != lv.counts[lvl]:
                raise ValueError(f"level {lvl}: the program's clusters "
                                 f"{list(counts)} are not the reference's "
                                 f"{lv.counts[lvl]}")
        elif item[0] == "keep":
            out["keep"][item[1]] = torch.as_tensor(item[2]).to(
                lv.pos[0].device)
    return out
