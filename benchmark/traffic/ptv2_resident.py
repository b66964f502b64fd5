"""``ptv2_resident``: PTv2 train steps on batches collated at set-up, no
loader in the window.

Set-up resolves the configuration's model first (a program without it
fails here, at once), builds the cell's synthetic rooms (the S3DIS cells'
generator, no cameras, cached at the configuration's grid, from the cell's
``data_seed``) through ``cli.train``'s ``build_dataset``, draws ``pool``
batches (all different) of crops by point count from the port's
``BatchLoader`` on the ``"ptv2"`` collate route, pinned to the cell's
level-0 capacity, builds the model through the zoo with weights drawn from
``--seed`` (:func:`seeded_vectors`), and the port's ``Trainer`` (AdamW, the multi-step schedule at
the recipe's milestones), and takes the check steps through its train step
on the pool's first batches, then one step on each other pooled batch.
Every ``--seed`` takes the same batches in an order of its own.  The
window cycles over the pool: each step is ``batch_to_torch`` plus the
train step, under the harness's ``step`` span, and the host waits for the
previous step's loss before it queues the next one.  Counts: the valid
level-0 points of every step completed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..harness import recipe
from ..harness.checks import free_cuda
from ..harness.ptv2_checks import PTv2Record, arch_of, ptv2_checks
from ..harness.ptv2_counts import (WindowFlops, forward_flops, knn_bytes,
                                   level_sizes)
from ..reference import ptv2 as ref

__all__ = ["Session", "seeded_vectors"]


@torch.no_grad()
def seeded_vectors(model, seed: int):
    """The harness's seeded weights (``harness/weights.py``), and then every
    bias drawn from N(0, 0.1^2) and every norm scale from N(1, 0.1^2), in
    one draw on the model's device, as a model some way into its training
    holds them: with zero biases the positional bias of a zero offset is
    near zero, and so a missing neighbour's slot, which the mask after the
    softmax removes, would weigh next to nothing.  Returns the whole state
    as host copies."""
    from ..harness.weights import seeded_state

    seeded_state(model, seed)
    vecs = [p for _, p in model.named_parameters() if p.ndim == 1]
    device = vecs[0].device
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + 1) % (2 ** 63))
    draw = torch.randn(sum(p.numel() for p in vecs), generator=gen,
                       device=device) * 0.1
    at = 0
    for name, p in model.named_parameters():
        if p.ndim == 1:
            d = draw[at:at + p.numel()]
            p.copy_(d if name.endswith("bias") else 1.0 + d)
            at += p.numel()
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


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

    def _data(self, rc):
        from deepviewagg_tpu_torch.cli.train import build_dataset
        from deepviewagg_tpu_torch.data.collate import Bucket

        ds = build_dataset(rc, train=True, device=self.device)
        bucket = Bucket(level_caps=list(self.params["bucket"]["level_caps"]),
                        num_batches=rc.data.batch_size)
        return ds, bucket

    def setup(self) -> None:
        from deepviewagg_tpu_torch.config.zoo import resolve_spec_from_cfg
        from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
        from deepviewagg_tpu_torch.train.trainer import Trainer, TrainerConfig

        d = self.cfg["data"]
        n_cls = self.cfg["model"]["num_classes"]
        kwargs = dict(self.params["scene"], seed=self.params["data_seed"],
                      cache_voxel_size=d["voxel_size"],
                      point_max=d["point_max"], point_feats=d["point_feats"])
        self.rc = recipe.run_config(self.cfg, self.workdir + "/areas",
                                    self.params["data_seed"], "synthetic",
                                    kwargs)
        resolve_spec_from_cfg(self.rc.model, n_cls)
        with self.spans.span("setup_data"):
            ds, bucket = self._data(self.rc)
        with self.spans.span("setup_model"):
            self.spec, self.model, _ = recipe.build_model(
                self.rc, n_cls, self.seed, self.device)
            self.init = seeded_vectors(self.model, self.seed)
        loader = BatchLoader(ds, bucket, self.rc.data.batch_size, [],
                             shuffle=True, seed=self.params["data_seed"],
                             graph="ptv2")
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
        tcfg = TrainerConfig(
            epochs=1, lovasz_weight=t["lovasz_weight"], base_lr=t["base_lr"],
            lr_schedule=t["lr_schedule"],
            lr_milestones=tuple(t["lr_milestones"]), lr_gamma=t["lr_gamma"],
            optimizer=t["optimizer"], weight_decay=t["weight_decay"],
            grad_clip=t["grad_clip"], run_dir=None, tensorboard=False)
        self.trainer = Trainer(self.model, n_cls, tcfg, seed=self.seed)
        self.optimizer = self.trainer.state.tx
        self.record = PTv2Record()
        with self.record.watch(self.model), \
                self.spans.span("setup_check_steps"):
            for k in range(self.params["check_steps"]):
                batch = self.pool[k]
                metrics = self._step(batch)
                self.record.after_step(self.model, metrics, batch)
        self.record.finish(self.model)
        with self.spans.span("setup_warmup"):
            # every pooled batch once before the window
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
        window's neighbour-search bound (:class:`WindowFlops`)."""
        arch = arch_of(self.cfg)
        name = (torch.cuda.get_device_name(0) if self.device.type == "cuda"
                else "H100")
        cache = {}
        flops = nbytes = 0.0
        for batch, _ in self.window_batches:
            key = id(batch)
            if key not in cache:
                inp = ref.inputs_from_batch(batch, self.device, arch,
                                            search=False)
                sizes = level_sizes(inp["levels"])
                cache[key] = (
                    3.0 * forward_flops(arch, self.cfg["model"]["in_channels"],
                                        self.cfg["model"]["num_classes"],
                                        sizes),
                    knn_bytes(arch, sizes))
                del inp
            flops += cache[key][0]
            nbytes += cache[key][1]
        self.window_batches = []
        return WindowFlops.of(flops, nbytes, name)

    def release(self) -> None:
        self.trainer = self.model = self.optimizer = None
        self.pool = None
        free_cuda()

    def check(self) -> Dict[str, float]:
        return ptv2_checks(self.record, self.init, self.cfg, self.device,
                           ref.Precision(self.cfg["precision"]["stated"]))

    def close(self) -> None:
        pass
