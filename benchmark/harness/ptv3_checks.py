"""The comparisons that decide ``correct`` in a PTv3 training cell.

Set-up drives the cell's ``Trainer`` from the seed through its first steps,
on batches that all differ, and keeps what the reference needs (the initial
parameters, the host batches, each step's random draws) and what the
program produced (each step's loss, the first step's logits and gradients,
the parameters after the last step).  After the window the plain reference
(:mod:`..reference.ptv3`) follows the same steps at the configuration's
stated precision, and numbers are compared:

* ``logit_rms_first``: the RMS of the first step's logit gap over the RMS
  of the reference's logits;
* ``loss_gap_first``: ``|loss - ref| / ref`` of the first step;
* ``loss_own_gap``: the first step's loss against the reference's loss
  function on the program's own logits (a fault of the loss alone);
* ``grad_gap_part``: per part of the model (the stem, each encoder and
  decoder stage, the head: :func:`part_of`), ``|g - g_ref| / |g_ref|``
  over the part's first gradients, the largest over the parts;
* ``update_gap_part``: the same for the parameters' change over the steps;
  a state left unchanged reads 1.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

from ..reference import ptv3 as ref
from .checks import free_cuda

__all__ = ["PTv3Record", "part_of", "compare", "reference_run",
           "program_run", "ptv3_checks", "hyper", "arch_of"]


def part_of(name: str) -> str:
    """``stem``, ``head``, or the encoder or decoder stage (``enc.enc2``,
    ``dec.dec0``) a parameter belongs to."""
    top = name.split(".")
    return ".".join(top[:2]) if top[0] in ("enc", "dec") else top[0]


def arch_of(cfg: Dict) -> Dict:
    return dict(cfg["model"]["arch"])


def hyper(cfg: Dict, total_steps: int) -> Dict:
    t = cfg["training"]
    return {"base_lr": t["base_lr"], "weight_decay": t["weight_decay"],
            "total_steps": total_steps,
            "block_lr_scale": t["block_lr_scale"]}


class PTv3Record:
    """What the program produced in the check steps."""

    def __init__(self):
        self.losses: List[float] = []
        self.batches: List[Dict] = []
        self.draws: List[list] = []
        self.logits = None
        self.grad: Dict[str, torch.Tensor] = {}
        self.final: Dict[str, torch.Tensor] = {}

    @contextlib.contextmanager
    def watch(self, model):
        """Keep the first step's logits and every step's draws."""

        def hook(mod, args, out):
            if self.logits is None:
                self.logits = out.detach().to("cpu", copy=True)

        handle = model.head.register_forward_hook(hook)
        model.record = []
        try:
            yield
        finally:
            handle.remove()
            model.record = None

    def after_step(self, model, metrics, batch) -> None:
        self.losses.append(float(metrics["loss"].detach()))
        self.batches.append(batch)
        self.draws.append(list(model.record))
        model.record = []
        if len(self.losses) == 1:
            self.grad = {n: (torch.zeros_like(p) if p.grad is None
                             else p.grad).detach().to("cpu", copy=True)
                         for n, p in model.named_parameters()}

    def finish(self, model) -> None:
        self.final = {n: p.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()}


def _n0(batch) -> int:
    return int(sum(batch["graph"]["counts"][0]))


def program_run(rec: PTv3Record, init: Dict[str, torch.Tensor],
                device) -> Dict:
    """The program's check steps in the reference's terms."""
    n = _n0(rec.batches[0])
    labels = torch.as_tensor(rec.batches[0]["labels"][:n]).to(
        device, torch.int64)
    logits = rec.logits[:n].to(device)
    own = float(ref.loss_fn(logits, labels))
    return {"loss": rec.losses, "logits": logits, "own_loss": own,
            "grad": {k: v.to(device) for k, v in rec.grad.items()},
            "delta": {k: rec.final[k].to(device) - init[k].to(device)
                      for k in rec.final}}


def reference_run(rec: PTv3Record, init: Dict[str, torch.Tensor],
                  cfg: Dict, total_steps: int, device, prec,
                  half: bool = False, faults: Sequence[str] = ()) -> Dict:
    """The reference's steps over the check batches (``half``: the second
    half of each batch's samples left out of the loss, a planted fault;
    ``faults``: the reference's planted PTv3 faults)."""
    arch = arch_of(cfg)
    levels = len(arch["enc_depths"])
    inputs = [ref.inputs_from_batch(b, device, levels, arch["stem_kernel"])
              for b in rec.batches]
    draws = [ref.map_draws(d, i) for d, i in zip(rec.draws, inputs)]
    if half:
        for inp in inputs:
            sample = inp["levels"].coords[0][:, 0]
            inp["labels"] = torch.where(
                sample < (int(sample.max()) + 1) // 2, inp["labels"], -1)
    params = {k: init[k].to(device) for k in rec.grad}
    out = ref.train_steps(params, inputs, arch, hyper(cfg, total_steps),
                          prec, draws, faults)
    n = _n0(rec.batches[0])
    labels = torch.as_tensor(rec.batches[0]["labels"][:n]).to(
        device, torch.int64)
    out["own_loss"] = float(ref.loss_fn(out["logits"], labels))
    del inputs, params
    free_cuda()
    return out


def _part_gaps(prog: Dict, refd: Dict) -> Dict[str, float]:
    num: Dict[str, float] = {}
    den: Dict[str, float] = {}
    for k, r in refd.items():
        p = part_of(k)
        num[p] = num.get(p, 0.0) + float((prog[k] - r).double().pow(2).sum())
        den[p] = den.get(p, 0.0) + float(r.double().pow(2).sum())
    return {p: (num[p] / den[p]) ** 0.5 if den[p] else 0.0 for p in num}


def _part_flips(prog: Dict, refd: Dict):
    """Per part, ``(share, gap)`` of the elements that moved the other way
    from the reference's: their share of the part's elements, and their
    share of the part's update gap, as ``_part_gaps`` reads it.  Adam moves
    an element by about the learning rate whatever its gradient's size, so
    a gradient that round-off turns round moves its element the other way
    by a whole step."""
    flips: Dict[str, int] = {}
    total: Dict[str, int] = {}
    num: Dict[str, float] = {}
    den: Dict[str, float] = {}
    for k, r in refd.items():
        p = part_of(k)
        other = torch.sign(prog[k]) != torch.sign(r)
        flips[p] = flips.get(p, 0) + int(other.sum())
        total[p] = total.get(p, 0) + r.numel()
        num[p] = num.get(p, 0.0) + float(
            ((prog[k] - r) * other).double().pow(2).sum())
        den[p] = den.get(p, 0.0) + float(r.double().pow(2).sum())
    return ({p: flips[p] / total[p] for p in flips},
            {p: (num[p] / den[p]) ** 0.5 if den[p] else 0.0 for p in num})


def compare(prog: Dict, refd: Dict, detail: bool = False) -> Dict:
    """The numbers compared between the program's check steps and the
    reference's (``detail``: also each part's gaps, its elements that moved
    the other way (:func:`_part_flips`), and every loss)."""
    g = _part_gaps(prog["grad"], refd["grad"])
    u = _part_gaps(prog["delta"], refd["delta"])
    diff = prog["logits"] - refd["logits"]
    out = {"logit_rms_first": float(diff.norm() / refd["logits"].norm()),
           "loss_gap_first": abs(prog["loss"][0] - refd["loss"][0])
           / abs(refd["loss"][0]),
           "loss_own_gap": abs(prog["loss"][0] - prog["own_loss"])
           / prog["own_loss"],
           "grad_gap_part": max(g.values()),
           "update_gap_part": max(u.values())}
    if detail:
        out["grad_gap_by_part"] = g
        out["update_gap_by_part"] = u
        share, gap = _part_flips(prog["delta"], refd["delta"])
        out["update_flip_share_by_part"] = share
        out["update_gap_flipped_by_part"] = gap
        out["losses"] = [list(prog["loss"]), list(refd["loss"])]
    return out


def ptv3_checks(rec: PTv3Record, init, cfg, total_steps: int, device,
                prec) -> Dict[str, float]:
    refd = reference_run(rec, init, cfg, total_steps, device, prec)
    out = compare(program_run(rec, init, device), refd)
    del refd
    free_cuda()
    return out
