"""The recipe's first training steps and an eval forward, in plain PyTorch.

SGD as the recipes configure it (the upstream's optimizer chain): the
gradients clipped to a global norm (scaled by ``clip / norm`` when the norm
reaches ``clip``), weight decay added to every parameter, momentum
``trace = g + momentum * trace`` without dampening, ``p -= lr * trace``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .model import Precision, forward, loss_fn

__all__ = ["train_steps", "eval_logits"]


def train_steps(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                batches: Sequence[Dict], hp: Dict, num_groups: int,
                prec: Precision) -> Dict:
    """Follow ``len(batches)`` steps from ``params`` (left untouched).

    Returns ``loss`` (per step), ``logits`` (the first step's), ``grad``
    (per parameter: the first step's clipped gradient, as the optimizer
    takes it) and ``delta`` (per parameter: its change over all the steps),
    float32 on the parameters' device."""
    names = list(params)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first = logits0 = None
    for step, inp in enumerate(batches):
        full = dict(P)
        full.update(buffers)
        logits = forward(full, inp, num_groups, True, prec)
        if logits0 is None:
            logits0 = logits.detach()
        loss = loss_fn(logits, inp["labels"])
        grads = torch.autograd.grad(loss, [P[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(P[k]) if g is None else g
                 for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
            factor = 1.0 if float(norm) < hp["grad_clip"] else \
                hp["grad_clip"] / float(norm)
            grads = [g * factor for g in grads]
            if first is None:
                first = {k: g.clone() for k, g in zip(names, grads)}
            lr = hp["base_lr"] * hp["lr_gamma"] ** sum(
                step >= m for m in hp.get("lr_milestones", ()))
            for k, g in zip(names, grads):
                g = g + hp["weight_decay"] * P[k]
                trace[k] = hp["momentum"] * trace[k] + g
                P[k] -= lr * trace[k]
        del loss, grads, logits
    delta = {k: (P[k].detach() - start[k]) for k in names}
    return {"loss": losses, "grad": first, "delta": delta,
            "logits": logits0}


@torch.no_grad()
def eval_logits(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                inp: Dict, num_groups: int, prec: Precision) -> torch.Tensor:
    """Eval-mode logits (running statistics in the batch norms)."""
    full = dict(params)
    full.update(buffers)
    return forward(full, inp, num_groups, False, prec)
