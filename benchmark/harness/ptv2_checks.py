"""The comparisons that decide ``correct`` in a PTv2 training cell.

Set-up drives the cell's ``Trainer`` from the seed through its first steps,
on batches that all differ, and keeps what the reference needs (the initial
parameters, the host batches, each step's level sizes and DropPath masks)
and what the program produced (each step's loss, the first step's logits,
gradients and neighbour tables, the parameters after the last step).  After
the window the plain reference (:mod:`..reference.ptv2`) follows the same
steps at the configuration's stated precision, and numbers are compared:
``logit_rms_first``, ``loss_gap_first`` and ``loss_own_gap`` as
:mod:`.ptv3_checks` reads them, and

* ``grad_gap_part``: :mod:`.ptv3_checks`'s per-part gap of the first
  gradients, the largest over the decoder's stages and the head
  (:data:`GRAD_PARTS`);
* ``update_gap_part``: the same for the parameters' change over the
  steps, over the head and the decoder's level-0 stage
  (:data:`UPDATE_PARTS`); a state left unchanged reads 1;
* ``update_flip_part``: per part, every part, the share of the elements
  whose change over the steps has another sign than the reference's
  (:func:`.ptv3_checks._part_flips`), the largest: AdamW moves an element
  by about the learning rate whatever the size of its gradient, so a
  gradient that rounding turns round flips a small share, and a gradient
  from another backward flips about half; a state left unchanged reads 1;
* ``loss_gap_last``: ``|loss - ref| / ref`` of the last check step, whose
  forward runs on the parameters that the earlier steps' backward and
  AdamW made, the encoder's included;
* ``knn_mismatch``: the slots of the first step's neighbour tables, over
  every level, whose row differs from the reference's brute force where
  the two rows' distances differ too (a tie of distances counts as equal).

The gaps leave out the parts that rounding alone moves nearly as far as a
fault: along the backward the first gradient's gap grows about threefold a
stage, so that the patch embedding and the encoder's stages read 0.3 to
0.9 between two sound runs at bfloat16, and their changes over three AdamW
steps 0.6 to 0.9, near the 1 of a state left unchanged (PERF.md, section
2).  The share of flipped signs and the last step's loss hold their
backward and updates to the reference's instead.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from ..reference import ptv2 as ref
from .checks import free_cuda
from .ptv3_checks import _part_flips, _part_gaps, part_of
from .ptv3_checks import compare as _compare
from .ptv3_checks import program_run as _program_run

__all__ = ["PTv2Record", "compare", "reference_inputs", "reference_run",
           "program_run", "ptv2_checks", "hyper", "arch_of", "knn_mismatch",
           "GRAD_PARTS", "UPDATE_PARTS"]

# the parts (:func:`.ptv3_checks.part_of`, by the start of their names)
# whose gaps are compared
GRAD_PARTS = ("head", "dec.")
UPDATE_PARTS = ("head", "dec.dec0")


def arch_of(cfg: Dict) -> Dict:
    return dict(cfg["model"]["arch"])


def hyper(cfg: Dict) -> Dict:
    t = cfg["training"]
    return {"base_lr": t["base_lr"], "weight_decay": t["weight_decay"],
            "lr_milestones": list(t["lr_milestones"]),
            "lr_gamma": t["lr_gamma"]}


class PTv2Record:
    """What the program produced in the check steps."""

    def __init__(self):
        self.losses: List[float] = []
        self.batches: List[Dict] = []
        self.draws: List[list] = []
        self.logits = None
        self.knn: Dict[int, torch.Tensor] = {}
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
        draws = list(model.record)
        model.record = []
        if len(self.losses) == 1:
            self.knn = {d[1]: d[2] for d in draws if d[0] == "knn"}
            self.grad = {n: (torch.zeros_like(p) if p.grad is None
                             else p.grad).detach().to("cpu", copy=True)
                         for n, p in model.named_parameters()}
        self.draws.append([d for d in draws if d[0] != "knn"])

    def finish(self, model) -> None:
        self.final = {n: p.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()}


def _n0(batch) -> int:
    return int(sum(batch["graph"]["counts"][0]))


def program_run(rec: PTv2Record, init: Dict[str, torch.Tensor],
                device) -> Dict:
    """The program's check steps in the reference's terms."""
    out = _program_run(rec, init, device)
    n = _n0(rec.batches[0])
    labels = torch.as_tensor(rec.batches[0]["labels"][:n]).to(
        device, torch.int64)
    out["own_loss"] = float(ref.loss_fn(out["logits"], labels))
    out["knn"] = {lvl: t.to(device, torch.int64)
                  for lvl, t in rec.knn.items()}
    return out


def reference_inputs(rec: PTv2Record, cfg: Dict, device,
                     faults: Sequence[str] = ()) -> List[Dict]:
    """The reference's inputs of the check batches."""
    arch = arch_of(cfg)
    return [ref.inputs_from_batch(b, device, arch, faults)
            for b in rec.batches]


def reference_run(rec: PTv2Record, init: Dict[str, torch.Tensor],
                  cfg: Dict, device, prec, faults: Sequence[str] = (),
                  inputs: Optional[List[Dict]] = None,
                  half: bool = False) -> Dict:
    """The reference's steps over the check batches (``faults``: the
    reference's planted PTv2 faults; ``inputs``: those of
    :func:`reference_inputs`, made here when not given; ``half``: the
    second half of each batch's samples left out of the loss, a planted
    fault)."""
    arch = arch_of(cfg)
    if inputs is None:
        inputs = reference_inputs(rec, cfg, device, faults)
    if half:
        inputs = [dict(inp) for inp in inputs]
        for inp in inputs:
            sample = inp["levels"].sample[0]
            inp["labels"] = torch.where(
                sample < (int(sample.max()) + 1) // 2, inp["labels"], -1)
    draws = [ref.map_draws(d, i) for d, i in zip(rec.draws, inputs)]
    params = {k: init[k].to(device) for k in rec.grad}
    out = ref.train_steps(params, inputs, arch, hyper(cfg), prec, draws,
                          faults)
    n = _n0(rec.batches[0])
    labels = torch.as_tensor(rec.batches[0]["labels"][:n]).to(
        device, torch.int64)
    out["own_loss"] = float(ref.loss_fn(out["logits"], labels))
    lv = inputs[0]["levels"]
    out["knn"] = {lvl: t[0] for lvl, t in enumerate(lv.knn)}
    out["positions"] = list(lv.pos)
    del inputs, params
    free_cuda()
    return out


def knn_mismatch(prog: Dict[int, torch.Tensor], refd: Dict) -> int:
    """Slots of the program's tables whose row is not the reference's, a tie
    of distances counting as equal (the distances recomputed from the
    reference's positions; a table of another shape counts whole)."""
    bad = 0
    for lvl, want in refd["knn"].items():
        got = prog.get(lvl)
        if got is None or got.shape != want.shape:
            bad += want.numel()
            continue
        pos = refd["positions"][lvl]
        padded = torch.cat([pos, pos.new_full((1, 3), float("nan"))])

        def dist(t):
            d = padded[torch.where(t >= 0, t, pos.shape[0])] - pos[:, None]
            return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]

        differ = got != want
        if bool(differ.any()):
            tie = dist(got) == dist(want)
            bad += int((differ & ~tie).sum())
    return bad


def _largest_gap(prog: Dict, refd: Dict, parts: Sequence[str]) -> float:
    """The largest :func:`.ptv3_checks._part_gaps` gap over the parts whose
    names start with one of ``parts``."""
    keep = {k: v for k, v in refd.items()
            if part_of(k).startswith(tuple(parts))}
    return max(_part_gaps(prog, keep).values())


def compare(prog: Dict, refd: Dict, detail: bool = False) -> Dict:
    """The numbers compared between the program's check steps and the
    reference's (``detail``: also every part's gaps and every loss, as
    :func:`.ptv3_checks.compare` gives them)."""
    out = _compare(prog, refd, detail)
    out["grad_gap_part"] = _largest_gap(prog["grad"], refd["grad"],
                                        GRAD_PARTS)
    out["update_gap_part"] = _largest_gap(prog["delta"], refd["delta"],
                                          UPDATE_PARTS)
    out["update_flip_part"] = max(
        _part_flips(prog["delta"], refd["delta"])[0].values())
    out["loss_gap_last"] = abs(prog["loss"][-1] - refd["loss"][-1]) \
        / abs(refd["loss"][-1])
    out["knn_mismatch"] = knn_mismatch(prog["knn"], refd)
    return out


def ptv2_checks(rec: PTv2Record, init, cfg, device, prec) -> Dict[str, float]:
    refd = reference_run(rec, init, cfg, device, prec)
    out = compare(program_run(rec, init, device), refd)
    del refd
    free_cuda()
    return out
