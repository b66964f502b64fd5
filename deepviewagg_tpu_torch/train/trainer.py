"""The Trainer: epoch loop, eval, best-checkpointing, logging.

The port of ``deepviewagg_tpu/train/trainer.py`` (reference
torch_points3d/trainer.py:34-290): epoch loop over a host data source
(collated numpy batches, moved to the model's device here), train and eval
steps, tracker updates every ``track_every`` batches, per-eval-frequency val
epochs, per-metric best checkpoints, gradient accumulation
(``optax.MultiSteps`` semantics), the NaN guard, BN-momentum milestones,
per-epoch ``.ply`` sample dumps (``visualize_every``) and the debugging hooks
(batch caps, conf/debugging).  With ``data_parallel`` every rank of the
default process group (``parallel.multihost.initialize``) runs a trainer on
its own batches (``view_parallel > 1``: ranks in groups of that many share
a batch and split its images); checkpoints and logs are written by rank 0.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.collate import batch_to_torch, device_view
from ..metrics.tracker import SegmentationTracker
from ..nn.norm import bn_momentum
from ..parallel import mesh as pmesh
from ..parallel.multihost import is_primary
from ..utils.logging import MetricLogger
from .checkpoint import CheckpointManager
from .optimizers import make_optimizer, make_schedule
from .step import TrainState, make_eval_step, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 100
    eval_frequency: int = 1
    lovasz_weight: float = 0.0
    view_loss_weight: float = 0.0
    base_lr: float = 0.1
    lr_schedule: str = "multi_step"
    lr_milestones: tuple = ()
    lr_gamma: float = 0.3
    total_steps: int = 100_000
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: Optional[float] = 10.0
    grad_accumulate: int = 1
    lr_scales: Optional[Dict[str, float]] = None
    # parameter-name prefixes left out of the optimizer (frozen towers)
    freeze_paths: Optional[tuple] = None
    run_dir: Optional[str] = None
    track_every: int = 10
    num_batches_cap: Optional[int] = None    # debugging.num_batches
    data_parallel: bool = False
    # view parallelism: shard the 2D towers' image axis over this many ranks
    # per data shard (parallel/mesh.py hybrid_parallel_step); requires
    # data_parallel and a world size it divides
    view_parallel: int = 1
    profile_epochs: tuple = ()               # epochs to trace (torch.profiler)
    class_weights: Optional[tuple] = None    # per-class CE weights
    visualize_every: int = 0                 # epochs between sample dumps
    nan_guard: bool = True        # abort + checkpoint on non-finite loss
    tensorboard: bool = True
    wandb: bool = False
    wandb_project: Optional[str] = None
    # BN momentum schedule {epoch: momentum} — the reference's bn_scheduler
    # (core/schedulers/bn_schedulers.py)
    bn_momentum_milestones: Optional[Dict[int, float]] = None
    log_fn: Callable[[str], None] = print


def _all_threads() -> Dict:
    """``profile``'s keyword that profiles every thread, where this torch
    has it."""
    try:
        from torch.profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class Trainer:
    """``Trainer(model, num_classes, cfg).fit(train_data, val_data)``.

    ``train_data`` / ``val_data`` are callables returning an iterable of
    collated numpy batches per epoch (the host input pipeline); the trainer
    moves each batch to the model's device.  ``init_hook(model)`` runs on
    the built model before the optimizer binds to it (e.g. to load other
    initial weights).  The dropout generator is a CPU ``torch.Generator``
    seeded from ``seed``, so a seed draws the same masks on every device.

    With ``cfg.data_parallel`` the default process group must be up; every
    rank builds its trainer from the same model and seed and feeds it its
    own batches (the same number per epoch on every rank).  Rank 0's
    parameters and buffers are broadcast before the optimizer binds; the
    step folds the data index into the generator (data rank 0 draws what a
    plain trainer draws); the train metrics count every data rank's
    predictions; each rank evaluates the whole val loader.
    """

    def __init__(self, model, num_classes: int, cfg: TrainerConfig,
                 seed: int = 0, run_config=None, init_hook=None):
        self.model = model
        self.cfg = cfg
        self.num_classes = num_classes
        self.run_config = run_config
        self.device = next(model.parameters()).device
        self.generator = torch.Generator().manual_seed(seed)
        self.primary = is_primary()
        hybrid = cfg.data_parallel and cfg.view_parallel > 1
        self.mesh = None
        if cfg.data_parallel:
            self.mesh = (pmesh.make_hybrid_mesh(cfg.view_parallel) if hybrid
                         else pmesh.make_mesh())
        if init_hook is not None:
            init_hook(model)
        if self.mesh is not None:
            pmesh.replicate(model, self.mesh)
        schedule = make_schedule(
            cfg.lr_schedule, cfg.base_lr, cfg.total_steps,
            cfg.lr_milestones, cfg.lr_gamma,
        )
        tx = make_optimizer(
            schedule, cfg.optimizer, cfg.momentum, cfg.weight_decay,
            cfg.grad_clip, cfg.lr_scales, freeze_paths=cfg.freeze_paths,
            grad_accumulate=cfg.grad_accumulate,
        )
        self.state = TrainState.create(model, tx)
        group = (None if self.mesh is None else
                 self.mesh.world if hybrid else self.mesh.data_group)
        self._train_step = make_train_step(
            model, cfg.lovasz_weight,
            class_weights=(None if cfg.class_weights is None
                           else list(cfg.class_weights)),
            view_loss_weight=cfg.view_loss_weight, group=group,
        )
        if hybrid:
            self._train_step = pmesh.hybrid_parallel_step(self._train_step,
                                                          self.mesh)
        elif self.mesh is not None:
            self._train_step = pmesh.data_parallel_step(self._train_step,
                                                        self.mesh)
        self._eval_step = make_eval_step(model)
        self._bn_momentum = None
        # every rank reads a checkpoint (resume), rank 0 alone writes one
        self.checkpoint = (
            CheckpointManager(cfg.run_dir, run_config=(
                run_config if self.primary else None))
            if cfg.run_dir else None
        )
        self.logger = MetricLogger(
            cfg.run_dir if self.primary else None,
            use_tensorboard=cfg.tensorboard and self.primary,
            use_wandb=cfg.wandb and self.primary,
            wandb_kwargs=({"project": cfg.wandb_project}
                          if cfg.wandb_project else None),
        )
        self.epoch = 0

    # ------------------------------------------------------------------
    def _maybe_update_bn_momentum(self):
        sched = self.cfg.bn_momentum_milestones
        if not sched:
            return
        current = None
        for ep in sorted(sched):
            if self.epoch >= ep:
                current = sched[ep]
        self._bn_momentum = current

    def _to_device(self, batch):
        return batch_to_torch(device_view(batch), self.device)

    def train_epoch(self, batches: Iterable) -> Dict[str, float]:
        tracker = SegmentationTracker(self.num_classes, "train")
        t0 = time.perf_counter()
        n = 0
        prev_loss = None
        for i, batch in enumerate(batches):
            if self.cfg.num_batches_cap and i >= self.cfg.num_batches_cap:
                break
            with bn_momentum(self._bn_momentum):
                self.state, metrics = self._train_step(
                    self.state, self._to_device(batch), self.generator)
            n += 1
            # check the PREVIOUS step's loss, as the JAX trainer does: at
            # most one poisoned update lands before the abort
            if self.cfg.nan_guard and prev_loss is not None:
                self._check_finite(prev_loss, i - 1)
            prev_loss = metrics["loss"]
            if i % self.cfg.track_every == 0:
                self._track_train(tracker, batch, metrics)
        if self.cfg.nan_guard and prev_loss is not None:
            self._check_finite(prev_loss, n - 1)
        if self.mesh is not None:
            # the confusion over every data rank's predictions, as the JAX
            # trainer tracks each device's
            cm = torch.from_numpy(tracker.cm.m).to(self.device)
            dist.all_reduce(cm, group=self.mesh.data_group)
            tracker.cm.m[:] = cm.cpu().numpy()
        out = tracker.get_metrics()
        out["train_batches"] = n
        out["train_time_s"] = time.perf_counter() - t0
        return out

    def _check_finite(self, loss, step: int):
        # the loss is replicated over the ranks: every rank stops here
        if np.isfinite(float(loss)):
            return
        if self.checkpoint is not None and self.primary:
            self.checkpoint.save_state("crash", self.state)
        raise FloatingPointError(
            f"non-finite loss at epoch {self.epoch} step {step} — state "
            "(one update past the first bad loss) saved as 'crash'; lower "
            "the lr or enable grad_clip"
        )

    def _track_train(self, tracker, batch, metrics):
        # one device-to-host copy of the predictions per tracked step
        tracker.track(
            metrics["preds"].cpu().numpy(), batch["labels"],
            np.asarray(batch["graph"]["levels"][0]["valid"]),
            losses={"loss": float(metrics["loss"])},
        )

    def _save_visuals(self, batch, preds):
        """Per-epoch sample dump (the reference Visualizer role,
        visualization/visualizer.py:10): one .ply with labels+preds."""
        if "pos" not in batch or self.cfg.run_dir is None or not self.primary:
            return
        from ..visualization import save_ply_snapshot

        n = batch["meta"]["num_valid"] if "meta" in batch else len(preds)
        save_ply_snapshot(
            os.path.join(self.cfg.run_dir, "viz", f"epoch_{self.epoch}.ply"),
            np.asarray(batch["pos"])[:n],
            labels=np.asarray(batch["labels"])[:n],
            preds=np.asarray(preds)[:n],
        )

    def eval_epoch(self, batches: Iterable, stage: str = "val") -> Dict[str, float]:
        tracker = SegmentationTracker(self.num_classes, stage)
        visualized = self.cfg.visualize_every <= 0 or (
            self.epoch % self.cfg.visualize_every != 0
        )
        for i, batch in enumerate(batches):
            if self.cfg.num_batches_cap and i >= self.cfg.num_batches_cap:
                break
            out = self._eval_step(self.state, self._to_device(batch))
            preds = out["preds"].cpu().numpy()
            tracker.track(
                preds, batch["labels"],
                np.asarray(batch["graph"]["levels"][0]["valid"]),
            )
            if not visualized:
                self._save_visuals(batch, preds)
                visualized = True
        return tracker.get_metrics()

    # ------------------------------------------------------------------
    def _profiled_train_epoch(self, batches: Iterable) -> Dict[str, float]:
        """``train_epoch`` under ``torch.profiler``; the trace goes to
        ``<run_dir>/profile_ep<epoch>.json`` (Chrome trace format).  It
        profiles every thread where this torch can, so the loader thread's
        ``dva::loader.*`` ranges land beside the step's ``dva::step.*`` and
        the device's events (``utils/trace.py``)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, **_all_threads()) as prof:
            m = self.train_epoch(batches)
        if self.primary:
            prof.export_chrome_trace(
                f"{self.cfg.run_dir}/profile_ep{self.epoch}.json")
        return m

    def fit(self, train_data: Callable, val_data: Optional[Callable] = None,
            epochs: Optional[int] = None) -> Dict[str, float]:
        log = self.cfg.log_fn if self.primary else (lambda line: None)
        all_metrics: Dict[str, float] = {}
        for _ in range(epochs or self.cfg.epochs):
            self.epoch += 1
            self._maybe_update_bn_momentum()
            if self.epoch in self.cfg.profile_epochs and self.cfg.run_dir:
                m = self._profiled_train_epoch(train_data())
            else:
                m = self.train_epoch(train_data())
            all_metrics.update(m)
            log(f"epoch {self.epoch}: "
                + " ".join(f"{k}={v:.3f}" for k, v in m.items()))
            if val_data is not None and self.epoch % self.cfg.eval_frequency == 0:
                vm = self.eval_epoch(val_data(), "val")
                all_metrics.update(vm)
                log(f"epoch {self.epoch} [val]: "
                    + " ".join(f"{k}={v:.3f}" for k, v in vm.items()))
            self.logger.log(all_metrics, self.epoch)
            if self.checkpoint is not None and self.primary:
                directions = {
                    k: SegmentationTracker.metric_direction(k)
                    for k in all_metrics
                    if k.endswith(("miou", "acc", "macc", "loss"))
                }
                self.checkpoint.save_best(self.state, all_metrics, directions)
        return all_metrics
