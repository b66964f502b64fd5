"""``resident``: train steps on batches collated at set-up, no loader.

Set-up draws ``pool`` batches (at least 4, all different) from the port's
``BatchLoader`` over the cell's data, made from its ``data_seed``: the
synthetic areas of the ``loop`` traffic (``dataset: synthetic``) or a
synthetic street of camera-family windows held in memory (``dataset:
street``, :mod:`..harness.street`).  Every ``--seed`` takes the same
batches (the same work), in an order of its own, with weights of its own.  It builds the port's ``Trainer`` and
takes the check steps through its train step on the pool's first batches.
The window cycles over the pool: each step is ``batch_to_torch`` plus the
train step, and the host waits for the previous step's loss before it
queues the next one (as the port's trainer does).  Counts: valid voxels of
every step completed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..harness import recipe
from ..harness.checks import (TrainRecord, free_cuda, stated_precision,
                              train_checks)
from ..harness.counts import forward_flops
from ..reference.graph import build_graph
from ..reference.model import NUM_LEVELS, inputs_from_batch

__all__ = ["Session"]


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

    def setup(self) -> None:
        from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
        from deepviewagg_tpu_torch.train.trainer import Trainer

        with self.spans.span("setup_data"):
            self.rc, ds, bucket = recipe.cell_data(
                self.cfg, self.params, self.workdir, self.device)
        data = recipe.RecordingDataset(ds)
        n_cls = self.cfg["model"]["num_classes"]
        with self.spans.span("setup_model"):
            self.spec, self.model, self.init = recipe.build_model(
                self.rc, n_cls, self.seed, self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        loader = BatchLoader(data, bucket, self.rc.data.batch_size, [0],
                             shuffle=True, seed=self.params["data_seed"],
                             conv0_kernel=self.spec.stem_kernel)
        self.pool = []
        t_pool = time.perf_counter()
        for _ in range(20):
            if len(self.pool) == self.params["pool"]:
                break
            # a batch past a camera family's image cap ends the loader's
            # pass; the pool takes the next pass's batches
            it = iter(loader)
            try:
                while len(self.pool) < self.params["pool"]:
                    b = next(it)
                    self.pool.append((b, data.take(b)))
            except ValueError:
                pass
            finally:
                it.close()
                data.coords.clear()
        self.spans.times["setup_pool"].append(time.perf_counter() - t_pool)
        # every seed takes the same batches, in an order of its own
        shift = self.seed % len(self.pool)
        self.pool = self.pool[shift:] + self.pool[:shift]
        self.trainer = Trainer(self.model, n_cls,
                               recipe.trainer_config(self.rc),
                               seed=self.seed)
        self.optimizer = self.trainer.state.tx
        self.record = TrainRecord(self.names)
        with self.record.watch(self.model), \
                self.spans.span("setup_check_steps"):
            for k in range(self.params["check_steps"]):
                batch, coords = self.pool[k]
                metrics = self._step(batch)
                self.record.after_step(self.trainer.state, metrics, batch,
                                       coords)
        self.record.finish(self.model)

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
        voxels = steps = failed = 0
        prev = None
        k = self.params["check_steps"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            batch, coords = self.pool[k % len(self.pool)]
            k += 1
            with self.spans.span("step"):
                loss = self._step(batch)["loss"]
                if sync:
                    torch.cuda.synchronize()
            if prev is not None and not torch.isfinite(prev):
                failed += 1
            prev = loss
            if self.traced:
                self.window_batches.append((batch, coords))
            voxels += int(batch["meta"]["num_valid"])
            steps += 1
        if prev is not None and not torch.isfinite(prev):
            failed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return ({"voxels": voxels, "attempted": steps, "failed": failed},
                time.perf_counter() - t0)

    def window_flops(self) -> float:
        shapes = {k: tuple(v.shape) for k, v in self.init.items()}
        cache = {}
        total = 0.0
        for batch, coords in self.window_batches:
            key = id(batch)
            if key not in cache:
                inp = inputs_from_batch(batch, coords, "cpu")
                cache[key] = 3.0 * forward_flops(
                    shapes, inp, build_graph(inp["coords"], NUM_LEVELS))
            total += cache[key]
        self.window_batches = []
        return total

    def release(self) -> None:
        self.trainer = self.model = self.optimizer = None
        self.pool = None
        free_cuda()

    def check(self) -> Dict[str, float]:
        return train_checks(self.record, self.init, set(self.names),
                            recipe.hyper(self.cfg),
                            self.cfg["model"]["num_groups"], self.device,
                            stated_precision(self.cfg))

    def close(self) -> None:
        pass
