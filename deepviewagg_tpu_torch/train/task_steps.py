"""Train steps + a compact trainer for the non-segmentation tasks.

The port of ``deepviewagg_tpu/train/task_steps.py`` (the reference routes
every task through ``BaseModel`` subclasses with task-specific
``set_input`` / ``forward`` / losses and per-task trackers,
models/{classification,object_detection,panoptic,registration}/ +
metrics/).  Each task is one step over the shared :class:`TrainState`
(``step(state, batch, generator) -> (state, metrics)`` on a batch already on
the device; the parameters, the running statistics and the optimizer state
are updated in place), and :class:`TaskTrainer` is the thin epoch loop
driving it.  ``metrics`` holds ``loss``, ``grad_norm`` (the global norm of
the raw gradients, before clipping) and the task's own entries, as 0-d
tensors but for the panoptic ``preds``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..data.collate import batch_to_torch
from ..models.losses import segmentation_loss
from .optimizers import global_norm, make_optimizer, make_schedule
from .step import TrainState

__all__ = ["make_classification_step", "make_detection_step",
           "make_panoptic_step", "make_registration_step", "TaskTrainer"]


def _update(state: TrainState, model: nn.Module, loss: torch.Tensor,
            extra: Dict) -> tuple:
    """Backward of ``loss``, the gradient norm, one optimizer update."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = global_norm([p.grad for p in model.parameters()
                             if p.grad is not None])
    state.tx.update()
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": grad_norm, **extra}


def make_classification_step(model) -> Callable:
    """CE over per-sample logits (ref BackboneBasedModel classification,
    models/classification/); ``generator`` feeds the head's dropout."""
    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> tuple:
        labels = batch["cls_label"]
        model.train()
        logits = model({k: v for k, v in batch.items() if k != "cls_label"},
                       generator=generator)["logits"]
        valid = labels >= 0
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, 1, torch.clamp(labels, min=0).to(
            torch.int64)[:, None])[:, 0]
        n = torch.clamp(valid.sum(), min=1)
        loss = -torch.sum(torch.where(valid, ll, 0.0)) / n
        acc = torch.sum((logits.detach().argmax(dim=-1) == labels)
                        & valid) / n
        return _update(state, model, loss, {"acc": acc})

    return step


def make_detection_step(model) -> Callable:
    """VoteNet losses against the scene's padded GT boxes
    (``models/detection.py::votenet_loss``; ref object detection API)."""
    from ..models.detection import votenet_loss

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> tuple:
        model.train()
        out = model({k: v for k, v in batch.items() if k != "gt_boxes"})
        total, parts = votenet_loss(out, batch["gt_boxes"])
        return _update(state, model, total,
                       {f"loss_{k}": v.detach() for k, v in parts.items()})

    return step


def make_panoptic_step(model, num_instances: int = 64,
                       offset_weight: float = 1.0) -> Callable:
    """Semantic CE + PointGroup offset loss (``models/panoptic.py``; ref
    panoptic datasets carry per-point instance ids).  ``num_instances`` is
    the per-batch instance cap sizing the centroid table."""
    from ..models.panoptic import instance_loss

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> tuple:
        valid = batch["graph"]["levels"][0]["valid"]
        model.train()
        out = model({k: v for k, v in batch.items() if k != "instance"})
        sem = segmentation_loss(out["logits"], batch["labels"], valid)
        off = instance_loss(out["offsets"], batch["pos"], batch["instance"],
                            num_instances=num_instances, valid=valid)
        return _update(state, model, sem + offset_weight * off, {
            "loss_sem": sem.detach(), "loss_offset": off.detach(),
            "preds": out["logits"].detach().argmax(dim=-1)})

    return step


def make_registration_step(model) -> Callable:
    """Shared-backbone descriptors on both fragments + hardest-contrastive
    over the GT correspondences (``models/registration.py``; ref 3DMatch
    API).  The two train-mode passes update the running statistics in
    turn, fragment a's then b's, as the JAX step threads them."""
    from ..models.registration import hardest_contrastive

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None) -> tuple:
        pairs = batch["pairs"].to(torch.int64)
        model.train()
        da = model(batch["a"])
        db = model(batch["b"])
        loss = hardest_contrastive(
            da, db, pairs, valid_b=batch["b"]["graph"]["levels"][0]["valid"])
        # feature-match quality: the mean descriptor distance of the pairs
        with torch.no_grad():
            d = torch.linalg.vector_norm(
                da.index_select(0, pairs[:, 0])
                - db.index_select(0, pairs[:, 1]), dim=1)
        return _update(state, model, loss, {"pair_dist": torch.mean(d)})

    return step


@dataclasses.dataclass
class TaskTrainer:
    """Thin epoch loop for the task steps: iterate host batches, move each
    to ``device``, average the scalar metrics.  Adam at a constant learning
    rate, no weight decay, the gradients clipped at ``grad_clip``; the
    dropouts draw from one generator seeded ``seed + 1``."""

    model: nn.Module
    step_fn: Callable
    base_lr: float = 0.01
    optimizer: str = "adam"
    grad_clip: Optional[float] = 10.0
    log_fn: Callable[[str], None] = print
    device: str = "cuda"

    def init(self, seed: int = 0) -> TrainState:
        """Fresh parameters from ``seed`` (the model's own initialisers) and
        the optimizer bound to them."""
        from ..models.segmentation import init_parameters

        with torch.no_grad():
            init_parameters(self.model, torch.Generator().manual_seed(seed))
        tx = make_optimizer(make_schedule("constant", self.base_lr),
                            optimizer=self.optimizer, weight_decay=0.0,
                            grad_clip=self.grad_clip)
        self.state = TrainState.create(self.model, tx)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        return self.state

    @staticmethod
    def _strip_meta(batch):
        return {k: v for k, v in batch.items() if k != "meta"}

    def train_epoch(self, batches: Iterable) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        t0 = time.time()
        for batch in batches:
            moved = batch_to_torch(self._strip_meta(batch), self.device)
            self.state, metrics = self.step_fn(self.state, moved,
                                               self.generator)
            n += 1
            for k, v in metrics.items():
                if v.ndim == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
        out = {k: v / max(n, 1) for k, v in sums.items()}
        out["batches"] = n
        out["time_s"] = time.time() - t0
        return out

    def fit(self, make_batches: Callable, epochs: int = 1) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        for ep in range(1, epochs + 1):
            metrics = self.train_epoch(make_batches())
            self.log_fn(f"epoch {ep}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
        return metrics
