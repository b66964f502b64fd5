"""The comparisons that decide ``correct``, against the plain reference.

Training cells: set-up drives the cell's own training object from the seed
through its first steps, on batches that all differ, and keeps what the
reference needs (the initial state, the batches, the level-0 voxel
coordinates) and what the program produced (each step's loss, the momentum
trace after the first step, the parameters after the last).  After the
window the reference follows the same steps at the configuration's stated
precision, and numbers are compared:

* ``loss_gap``: ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap``: per parameter, the gap between the norms of the first
  gradient as the optimizer took it (the momentum trace after one step less
  the weight decay) and of the reference's, over the larger of the
  reference leaf's norm and the median leaf's of its part;
* ``update_gap``: the same for the parameters' change over the steps.

The last two are held per part of the model (each image branch, the sparse
UNet, the head: :func:`part_of`), as the median leaf's gap of each part and
the largest of those (``grad_gap_part``, ``update_gap_part``), so that a
fault in one part's backward shows even where the other parts hold most of
the leaves.  Parameters whose reference gradient norm is under a thousandth
of the median leaf's move by weight decay and round-off alone and are left
out of them (by that rule, not by name).

Eval cells: the logits that the program voted for a sample of its batches
(drawn from the seed; every time the window ran them) are held against the
reference's eval-mode logits at the stated precision.  ``logit_rms_rel``:
the RMS of their gap over the RMS of the gap between the reference at the
stated precision and the reference in float32, that is, in units of how far
rounding at the stated precision moves these logits (which swings tenfold
from seed to seed with the random weights); ``pred_gap``: the largest
shortfall of the program's predicted class below the reference's best, in
units of the reference logits' standard deviation.  The accumulated votes
are held against a sum of every logit handed to the accumulator
(``vote_err``, exact).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List

import numpy as np
import torch

from ..reference.model import Precision, inputs_from_batch, loss_fn
from ..reference.train import eval_logits, train_steps

__all__ = ["TrainRecord", "train_checks", "eval_checks", "free_cuda",
           "stated_precision", "part_of", "FLOAT32"]

# the reference with no rounding anywhere
FLOAT32 = Precision(tower="f32", sparse="f32")


def stated_precision(cfg: Dict) -> Precision:
    """The precision a configuration states for its towers and sparse
    convolutions."""
    return Precision(**cfg["precision"]["stated"])


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class TrainRecord:
    """What the program produced in the check steps."""

    def __init__(self, names: List[str]):
        self.names = names
        self.losses: List[float] = []
        self.trace1: Dict[str, torch.Tensor] = {}
        self.final: Dict[str, torch.Tensor] = {}
        self.batches: List[Dict] = []
        self.coords: List[np.ndarray] = []
        self.logits = None

    @contextlib.contextmanager
    def watch(self, model):
        """Keep the logits of the first check step's forward."""

        def hook(mod, args, out):
            if self.logits is None:
                self.logits = out.detach().to("cpu", copy=True)

        handle = model.head.register_forward_hook(hook)
        try:
            yield
        finally:
            handle.remove()

    def after_step(self, state, metrics, batch, coords) -> None:
        """Call after each check step with the step's ``TrainState`` and
        metrics."""
        self.losses.append(float(metrics["loss"].detach()))
        self.batches.append(batch)
        self.coords.append(coords)
        params = [p for g in state.tx.groups for p in g.params]
        if len(self.losses) == 1:
            # no trace yet: the step left the optimizer's state as it was
            traces = [t for g in state.tx.groups for t in g.state.get(
                "trace", [torch.zeros_like(p) for p in g.params])]
            by_id = {id(p): t for p, t in zip(params, traces)}
            for name, p in state.model.named_parameters():
                self.trace1[name] = by_id[id(p)].detach().to("cpu",
                                                              copy=True)

    def finish(self, model) -> None:
        self.final = {n: p.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()}


def _norms(d: Dict, keep: List[str]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(d[k].double())) for k in keep}


def part_of(name: str) -> str:
    """The part of the model a parameter belongs to: its image branch
    (``branch_l0``, ``branch_l0_1``, ...), ``head``, or ``unet`` (the 3D
    stem, the encoder and the decoder)."""
    top = name.split(".")[0]
    return top if top.startswith("branch") or top == "head" else "unet"


def _gaps_by_leaf(prog: Dict, ref: Dict, keep: List[str]) -> Dict[str, float]:
    """Per leaf: the gap between the norms over the larger of the
    reference leaf's norm and the median leaf's of its part."""
    pn, rn = _norms(prog, keep), _norms(ref, keep)
    by_part: Dict[str, List[float]] = {}
    for k in keep:
        by_part.setdefault(part_of(k), []).append(rn[k])
    med = {p: float(np.median(v)) for p, v in by_part.items()}
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med[part_of(k)])
            for k in keep}


def part_medians(gaps: Dict[str, float]) -> Dict[str, float]:
    """The median leaf's gap of each part."""
    by_part: Dict[str, List[float]] = {}
    for k, v in gaps.items():
        by_part.setdefault(part_of(k), []).append(v)
    return {p: float(np.median(v)) for p, v in sorted(by_part.items())}


def reference_run(rec: TrainRecord, init: Dict[str, torch.Tensor],
                  params_names, hp: Dict, num_groups: int, device,
                  prec: Precision, half: bool = False) -> Dict:
    """The reference's steps over the check batches (``half``: with the
    second half of each batch's samples left out of the loss, the mean
    taken over the rest: a planted fault)."""
    params = {k: v.to(device) for k, v in init.items() if k in params_names}
    buffers = {k: v.to(device) for k, v in init.items()
               if k not in params_names}
    inputs = [inputs_from_batch(b, c, device)
              for b, c in zip(rec.batches, rec.coords)]
    if half:
        for inp in inputs:
            sample = inp["coords"][:, 0]
            inp["labels"] = torch.where(
                sample < (int(sample.max()) + 1) // 2, inp["labels"], -1)
    out = train_steps(params, buffers, inputs, hp, num_groups, prec)
    out["own_loss"] = own_loss(out["logits"], first_labels(rec, device))
    del inputs, params, buffers
    free_cuda()
    return out


def first_labels(rec: TrainRecord, device) -> torch.Tensor:
    n = len(rec.coords[0])
    return torch.as_tensor(rec.batches[0]["labels"][:n]).to(
        device, torch.int64)


def own_loss(logits: torch.Tensor, labels: torch.Tensor,
             samples=None) -> float:
    """The cross-entropy of ``logits`` (``samples``: a mask of the voxels
    whose loss counts; the others are left out, as the half-batch fault
    leaves them)."""
    if samples is not None:
        labels = torch.where(samples, labels, -1)
    return float(loss_fn(logits, labels))


def program_run(rec: TrainRecord, init: Dict[str, torch.Tensor], hp: Dict,
                device) -> Dict:
    """The program's check steps in the reference's terms."""
    wd = hp["weight_decay"]
    p0 = {k: init[k].to(device) for k in rec.final}
    n = len(rec.coords[0])
    logits = rec.logits[:n].to(device)
    return {"loss": rec.losses, "logits": logits,
            "own_loss": own_loss(logits, first_labels(rec, device)),
            "grad": {k: rec.trace1[k].to(device) - wd * p0[k] for k in p0},
            "delta": {k: rec.final[k].to(device) - p0[k] for k in p0}}


def compare(prog: Dict, ref: Dict, detail: bool = False) -> Dict:
    """The numbers compared between a run of the check steps and the
    reference's: the first step's loss and logits, the first step's loss
    against the cross-entropy of its own logits, the largest over the parts
    of the median leaf's first gradient and change; with ``detail`` also
    each part's, the worst leaves and the later steps' losses (the look
    behind the choice of those numbers)."""
    rg = _norms(ref["grad"], list(ref["grad"]))
    med = float(np.median(list(rg.values())))
    keep = [k for k in ref["grad"] if rg[k] >= 1e-3 * med]
    g = _gaps_by_leaf(prog["grad"], ref["grad"], keep)
    u = _gaps_by_leaf(prog["delta"], ref["delta"], keep)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    scale = float(ref["logits"].abs().max())
    diff = prog["logits"] - ref["logits"]
    gp, up = part_medians(g), part_medians(u)
    out = {"loss_gap_first": loss[0],
           "logit_err_first": float(diff.abs().max()) / scale,
           "logit_rms_first": float(diff.norm() / ref["logits"].norm()),
           "loss_own_gap": abs(prog["loss"][0] - prog["own_loss"])
           / prog["own_loss"],
           "grad_gap_part": max(gp.values()),
           "update_gap_part": max(up.values()),
           "leaves_compared": float(len(keep)),
           "leaves": float(len(ref["grad"]))}
    if detail:
        out["grad_gap_by_part"] = gp
        out["update_gap_by_part"] = up
        out["loss_gap_all"] = max(loss)
        out["grad_gap_worst"] = max(g.values())
        out["update_gap_worst"] = max(u.values())
        out["worst_grad"] = sorted(g.items(), key=lambda kv: -kv[1])[:8]
        out["worst_update"] = sorted(u.items(), key=lambda kv: -kv[1])[:8]
        out["losses"] = [list(prog["loss"]), list(ref["loss"])]
    return out


def train_checks(rec: TrainRecord, init: Dict[str, torch.Tensor],
                 params_names, hp: Dict, num_groups: int, device,
                 prec: Precision) -> Dict[str, float]:
    """The gaps between the program's check steps and the reference's."""
    ref = reference_run(rec, init, params_names, hp, num_groups, device, prec)
    out = compare(program_run(rec, init, hp, device), ref)
    del ref
    free_cuda()
    return out


def logit_gaps(got: torch.Tensor, ref: torch.Tensor,
               ref32: torch.Tensor) -> Dict[str, float]:
    """``logit_err``, ``logit_rms``, ``logit_rms_rel`` and ``pred_gap`` of
    logits ``got`` against the reference's ``ref`` at the stated precision,
    ``ref32`` the reference's in float32 (all ``[n, classes]``)."""
    scale = float(ref.abs().max())
    std = float(ref.std())
    best = ref.max(dim=1).values
    pred = got.argmax(dim=1)
    short = best - ref.gather(1, pred[:, None])[:, 0]
    return {"logit_err": float((got - ref).abs().max()) / scale,
            "logit_rms": float((got - ref).norm() / ref.norm()),
            "logit_rms_rel": float((got - ref).norm() / (ref32 - ref).norm()),
            "pred_gap": float(short.max()) / std}


def eval_references(samples: List[Dict], init: Dict[str, torch.Tensor],
                    params_names, num_groups: int, device,
                    prec: Precision) -> List[torch.Tensor]:
    """The reference's eval logits of each sampled batch."""
    params = {k: v.to(device) for k, v in init.items() if k in params_names}
    buffers = {k: v.to(device) for k, v in init.items()
               if k not in params_names}
    out = []
    for s in samples:
        inp = inputs_from_batch(s["batch"], s["coords"], device)
        out.append(eval_logits(params, buffers, inp, num_groups, prec))
        del inp
    del params, buffers
    return out


def vote_error(votes, log) -> float:
    """The largest gap between the accumulator's votes and every logit
    handed to it, summed again per original id (inf where a cloud is
    missing or extra)."""
    again: Dict[str, np.ndarray] = {}
    for cloud, ids, logits in log:
        acc = again.setdefault(cloud, np.zeros_like(votes.votes(cloud)[0]))
        np.add.at(acc, ids, logits)
    if set(again) != set(votes.clouds()):
        return float("inf")
    return max((float(np.abs(votes.votes(c)[0] - acc).max())
                for c, acc in again.items()), default=0.0)


def eval_checks(samples: List[Dict], init: Dict[str, torch.Tensor],
                params_names, num_groups: int, device, votes, log,
                prec: Precision) -> Dict[str, float]:
    """``samples``: per sampled batch ``{"batch", "coords", "logits": [the
    program's logits of each time it ran, [n, classes]]}``; ``votes``: the
    program's accumulator; ``log``: every ``(cloud, ids, logits)`` it was
    handed."""
    keys = ("logit_err", "logit_rms", "logit_rms_rel", "pred_gap")
    if not samples:
        out = {k: float("inf") for k in keys}
        out["vote_err"] = vote_error(votes, log)
        return out
    args = (samples, init, params_names, num_groups, device)
    refs = eval_references(*args, prec)
    refs32 = eval_references(*args, FLOAT32)
    out = dict.fromkeys(keys, 0.0)
    for s, ref, ref32 in zip(samples, refs, refs32):
        for got in s["logits"]:
            g = logit_gaps(torch.as_tensor(got, device=device), ref, ref32)
            for k in out:
                out[k] = max(out[k], g[k])
    del refs, refs32
    free_cuda()
    out["vote_err"] = vote_error(votes, log)
    return out
