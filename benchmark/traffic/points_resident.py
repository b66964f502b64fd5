"""``points_resident``: PTv3 train steps on batches collated at set-up, no
loader in the window.

Set-up builds the cell's synthetic rooms (the S3DIS cells' generator, no
cameras, cached at the configuration's grid, from the cell's ``data_seed``)
through ``cli.train``'s ``build_dataset``, draws ``pool`` batches (all
different) of crops by point count from the port's ``BatchLoader`` on the
``"ptv3"`` collate route, pinned to the cell's level capacities, builds the
model through the zoo with weights drawn from ``--seed``, and the port's
``Trainer`` (AdamW, the one-cycle schedule over the recipe's steps, the
block parameters at their rate), and takes the check steps through its
train step on the pool's first batches, then one step on each other pooled
batch, so that the window meets no shape it has not run.  Every ``--seed``
takes the same batches in an order of its own.  The window cycles over the
pool: each step is ``batch_to_torch`` plus the train step, under the
harness's ``step`` span, and the host waits for the previous step's loss
before it queues the next one.  Counts: the valid level-0 points of every step completed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..harness import recipe
from ..harness.checks import free_cuda
from ..harness.ptv3_checks import PTv3Record, arch_of, ptv3_checks
from ..harness.ptv3_counts import (WindowFlops, attention_bound_s,
                                   forward_flops, level_counts)
from ..reference import ptv3 as ref

__all__ = ["Session", "total_steps"]


def total_steps(cfg: Dict) -> int:
    """The one-cycle schedule's length: the recipe's epochs times its
    steps per epoch."""
    t, d = cfg["training"], cfg["data"]
    return int(t["epochs"]) * -(-int(d["samples_per_epoch"])
                                // int(d["batch_size"]))


class Session:
    training = True

    def __init__(self, cfg: Dict, params: Dict, seed: int, device, spans,
                 workdir: str):
        self.cfg, self.params, self.seed = cfg, params, int(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.workdir = workdir
        self.traced = False
        self.window_batches = []

    def _data(self):
        from deepviewagg_tpu_torch.cli.train import build_dataset
        from deepviewagg_tpu_torch.data.collate import Bucket

        d = self.cfg["data"]
        kwargs = dict(self.params["scene"], seed=self.params["data_seed"],
                      cache_voxel_size=d["voxel_size"],
                      point_max=d["point_max"], point_feats=d["point_feats"])
        rc = recipe.run_config(self.cfg, self.workdir + "/areas",
                               self.params["data_seed"], "synthetic", kwargs)
        ds = build_dataset(rc, train=True, device=self.device)
        bucket = Bucket(level_caps=list(self.params["bucket"]["level_caps"]),
                        num_batches=d["batch_size"])
        return rc, ds, bucket

    def setup(self) -> None:
        from deepviewagg_tpu_torch.config.zoo import recipe_lr_keywords
        from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
        from deepviewagg_tpu_torch.train.trainer import Trainer, TrainerConfig

        with self.spans.span("setup_data"):
            self.rc, ds, bucket = self._data()
        n_cls = self.cfg["model"]["num_classes"]
        with self.spans.span("setup_model"):
            self.spec, self.model, self.init = recipe.build_model(
                self.rc, n_cls, self.seed, self.device)
        loader = BatchLoader(ds, bucket, self.rc.data.batch_size, [],
                             shuffle=True, seed=self.params["data_seed"],
                             conv0_kernel=self.spec.stem_kernel,
                             graph="ptv3")
        t_pool = time.perf_counter()
        it = iter(loader)
        try:
            self.pool = [next(it) for _ in range(self.params["pool"])]
        finally:
            it.close()
        self.spans.times["setup_pool"].append(time.perf_counter() - t_pool)
        shift = self.seed % len(self.pool)
        self.pool = self.pool[shift:] + self.pool[:shift]
        t = self.cfg["training"]
        self.total_steps = total_steps(self.cfg)
        tcfg = TrainerConfig(
            epochs=1, lovasz_weight=t["lovasz_weight"], base_lr=t["base_lr"],
            lr_schedule=t["lr_schedule"], total_steps=self.total_steps,
            optimizer=t["optimizer"], weight_decay=t["weight_decay"],
            grad_clip=t["grad_clip"],
            lr_keywords=recipe_lr_keywords(self.rc.model.name,
                                           self.rc.model.overrides),
            run_dir=None, tensorboard=False)
        self.trainer = Trainer(self.model, n_cls, tcfg, seed=self.seed)
        self.optimizer = self.trainer.state.tx
        self.record = PTv3Record()
        with self.record.watch(self.model), \
                self.spans.span("setup_check_steps"):
            for k in range(self.params["check_steps"]):
                batch = self.pool[k]
                metrics = self._step(batch)
                self.record.after_step(self.model, metrics, batch)
        self.record.finish(self.model)
        with self.spans.span("setup_warmup"):
            # every pooled batch's shapes once before the window
            for batch in self.pool[self.params["check_steps"]:]:
                self._step(batch)

    def _step(self, batch):
        from deepviewagg_tpu_torch.data.collate import (batch_to_torch,
                                                        device_view)

        with self.spans.span("to_device"):
            dev = batch_to_torch(device_view(batch), self.device)
        t = self.trainer
        t.state, metrics = t._train_step(t.state, dev, t.generator)
        return metrics

    def replay_step(self, batch) -> None:
        """One train step on ``batch`` after the window (the traced run's
        count of the segment kernels' bytes)."""
        self._step(batch)

    def trace_mode(self) -> None:
        self.traced = True

    def window(self, seconds: float):
        sync = self.traced and self.device.type == "cuda"
        self.spans.times["step"].clear()
        points = steps = failed = 0
        prev = None
        k = self.params["check_steps"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            batch = self.pool[k % len(self.pool)]
            k += 1
            with self.spans.span("step"):
                loss = self._step(batch)["loss"]
                if sync:
                    torch.cuda.synchronize()
            if prev is not None and not torch.isfinite(prev):
                failed += 1
            prev = loss
            if self.traced:
                self.window_batches.append((batch, None))
            points += int(batch["meta"]["num_valid"])
            steps += 1
        if prev is not None and not torch.isfinite(prev):
            failed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return ({"voxels": points, "attempted": steps, "failed": failed},
                time.perf_counter() - t0)

    def window_flops(self) -> float:
        """The window's model FLOPs (three times each forward's), with the
        window's attention bound (:class:`WindowFlops`)."""
        arch = arch_of(self.cfg)
        name = (torch.cuda.get_device_name(0) if self.device.type == "cuda"
                else "H100")
        cache = {}
        flops = bound = 0.0
        for batch, _ in self.window_batches:
            key = id(batch)
            if key not in cache:
                inp = ref.inputs_from_batch(batch, self.device,
                                            len(arch["enc_depths"]),
                                            arch["stem_kernel"])
                lv = inp["levels"]
                cache[key] = (
                    3.0 * forward_flops(arch, self.cfg["model"]["in_channels"],
                                        self.cfg["model"]["num_classes"], lv),
                    attention_bound_s(arch, level_counts(lv), name))
                del inp
            flops += cache[key][0]
            bound += cache[key][1]
        self.window_batches = []
        out = WindowFlops(flops)
        out.attention_core_bound_s = bound
        return out

    def release(self) -> None:
        self.trainer = self.model = self.optimizer = None
        self.pool = None
        free_cuda()

    def check(self) -> Dict[str, float]:
        return ptv3_checks(self.record, self.init, self.cfg,
                           self.total_steps, self.device,
                           ref.Precision(self.cfg["precision"]["stated"]))

    def close(self) -> None:
        pass
