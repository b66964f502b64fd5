"""Train / eval step factories.

The port of ``deepviewagg_tpu/train/step.py``: the per-batch contract of the
reference's ``BaseModel.optimize_parameters`` (models/base_model.py:241-267):
forward, loss, backward, clip, optimizer + scheduler updates.  bf16 operands
with float32 parameters and accumulation replace AMP.  The JAX step is a pure
function over an immutable state; here the model's parameters, its running
statistics and the optimizer's state are updated in place, and the returned
state is the one passed in.

Steps optionally run on every rank of a process group (see
``parallel.mesh``): the gradients, the loss and the running statistics are
then averaged over the group, as the JAX step ``pmean``s them over the mesh
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.losses import segmentation_loss, view_level_loss
from ..models.segmentation import No3DSeg
from ..parallel.collectives import all_reduce_mean_
from ..utils import trace
from .optimizers import Optimizer, global_norm

__all__ = ["TrainState", "make_train_step", "make_eval_step"]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and running statistics), the optimizer bound to
    its parameters, and the number of steps taken."""

    model: nn.Module
    tx: Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        return cls(model=model, tx=tx.init(model.named_parameters()), step=0)


def make_train_step(
    model: nn.Module,
    lovasz_weight: float = 0.0,
    class_weights=None,
    ignore_unseen: Optional[bool] = None,
    view_loss_weight: float = 0.0,
    group=None,
) -> Callable:
    """Returns ``step(state, batch, generator) -> (state, metrics)`` with
    ``metrics = {loss, preds, grad_norm}``; ``grad_norm`` is the global norm
    of the raw gradients, before clipping.

    ``generator`` feeds the model's dropouts (None: all of them are the
    identity).  ``ignore_unseen``: mask points no view reaches out of the
    loss — the reference does this for the image-only No3D models
    (no3d.py:130-134); defaults to True for a ``No3DSeg``, False otherwise.
    ``view_loss_weight``: adds the reference's view-level loss over a
    model's ``view_logits`` (no3d.py:139-155) where it emits them.

    ``group``: a ``torch.distributed`` group whose every rank runs the step
    on its own batch (``parallel.mesh``).  After the backward pass the
    gradients of the optimizer's parameters (None counts as zero) are
    replaced by their mean over the group, before the gradient norm, the
    clipping and the update (and, with gradient accumulation, before they
    are accumulated); the loss and every running statistic (the buffers)
    are replaced by theirs too: the masked batch norms' are equal across
    the group already, a tower BatchNorm's were taken from its own rank's
    images.

    Traced (``utils/trace.py``), a step is the spans ``step.forward`` (the
    model and the loss), ``step.backward`` (``zero_grad`` and the backward
    pass), ``step.grad_mean`` (with a group) and ``step.optimizer`` (the
    gradient norm and the update).
    """
    if ignore_unseen is None:
        ignore_unseen = isinstance(model, No3DSeg)

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> tuple:
        valid = batch["graph"]["levels"][0]["valid"]
        with trace.span("step.forward"):
            model.train()
            out = model(batch, generator=generator)
            loss_valid = valid
            if ignore_unseen and "x_seen" in out:
                loss_valid = loss_valid & out["x_seen"]
            loss = segmentation_loss(out["logits"], batch["labels"],
                                     loss_valid, lovasz_weight, class_weights)
            if view_loss_weight > 0 and "view_logits" in out:
                ex = out["view_extras"]
                loss = loss + view_loss_weight * view_level_loss(
                    out["view_logits"], batch["labels"], ex["view_point_id"],
                    ex["view_valid"])
        with trace.span("step.backward"):
            model.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        if group is not None:
            with trace.span("step.grad_mean"):
                params = [p for g in state.tx.groups for p in g.params]
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                loss = loss.reshape(1)
                all_reduce_mean_([p.grad for p in params] + [loss]
                                 + list(model.buffers()), group)
                loss = loss[0]
        with trace.span("step.optimizer"):
            grad_norm = global_norm([p.grad for p in model.parameters()
                                     if p.grad is not None])
            # the schedule counts the optimizer's real updates (with
            # gradient accumulation, fewer than the mini-steps counted by
            # state.step)
            state.tx.update()
        state.step += 1
        metrics = {
            "loss": loss,
            "preds": out["logits"].detach().argmax(dim=-1),
            "grad_norm": grad_norm,
        }
        return state, metrics

    return step


def make_eval_step(model: nn.Module, mc_dropout: bool = False) -> Callable:
    """``mc_dropout=True`` keeps dropout active at eval — the reference's
    ``enable_dropout_in_eval`` voting mode (base_model.py:480-487,
    trainer.py:230-258); pass a distinct generator state per voting run."""

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> Dict:
        model.eval()
        with torch.no_grad(), trace.span("eval.forward"):
            out = model(batch, generator=generator if mc_dropout else None)
        res = {"logits": out["logits"],
               "preds": out["logits"].argmax(dim=-1)}
        if "x_seen" in out:
            # surfaced so eval can copy nearest-seen logits onto unseen
            # points (no3d.py:105-126 propagate_unseen)
            res["x_seen"] = out["x_seen"]
        return res

    return step
