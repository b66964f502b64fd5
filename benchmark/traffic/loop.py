"""``loop``: the experiment loop a training user runs.

Set-up builds the cell's synthetic areas from its ``data_seed`` (the
same rooms, and, through the dataset's own generator, the same spheres and
augmentations for every ``--seed``, which draws the weights) under the
run's scratch directory through the port's dataset path, its
``BatchLoader`` (one prefetch thread, the recipe's augmentations) and its
``Trainer``, and drives that trainer through its first steps on the
loader's first batches (the check steps, which are also the warm-up: every
batch of a bucket has one shape).  The window keeps feeding the same
trainer from the same loader until ``--seconds`` have passed; the steps
under way then finish.  Counts: valid voxels of every step completed.
"""

from __future__ import annotations

import itertools
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
        self._batches = None

    def setup(self) -> None:
        from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
        from deepviewagg_tpu_torch.train.trainer import Trainer

        with self.spans.span("setup_data"):
            self.rc, ds, self.bucket = recipe.cell_data(
                self.cfg, self.params, self.workdir, self.device)
        self.data = recipe.RecordingDataset(ds)
        n_cls = self.cfg["model"]["num_classes"]
        with self.spans.span("setup_model"):
            self.spec, self.model, self.init = recipe.build_model(
                self.rc, n_cls, self.seed, self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.loader = BatchLoader(self.data, self.bucket,
                                  self.rc.data.batch_size, [0], shuffle=True,
                                  seed=self.params["data_seed"],
                                  conv0_kernel=self.spec.stem_kernel)
        self.trainer = Trainer(self.model, n_cls,
                               recipe.trainer_config(self.rc),
                               seed=self.seed)
        self.optimizer = self.trainer.state.tx
        self._batches = self._cycle()
        self.record = TrainRecord(self.names)
        step = self.trainer._train_step

        def checked(state, batch, generator):
            state, metrics = step(state, batch, generator)
            host, coords = self._last
            self.record.after_step(state, metrics, host, coords)
            return state, metrics

        self.trainer._train_step = checked
        with self.record.watch(self.model), \
                self.spans.span("setup_check_steps"):
            self.trainer.train_epoch(itertools.islice(
                self._fed(keep=True), self.params["check_steps"]))
        self.trainer._train_step = step
        self.record.finish(self.model)

    def _cycle(self):
        while True:
            yield from self.loader

    def _fed(self, keep=False, deadline=None):
        """Batches from the loader, the host's wait for each timed; with
        ``keep`` the last batch and its coordinates stay for the check."""
        sync = self.traced and self.device.type == "cuda"
        t_step = None
        while deadline is None or time.perf_counter() < deadline:
            if t_step is not None:
                if sync:
                    torch.cuda.synchronize()
                self.spans.times["step"].append(time.perf_counter() - t_step)
                self.spans.close("step")
            with self.spans.span("loader_wait"):
                batch = next(self._batches)
            coords = self.data.take(batch)
            if keep:
                self._last = (batch, coords)
            elif self.traced:
                self.window_batches.append((batch, coords))
            self.counted += int(batch["meta"]["num_valid"])
            self.steps += 1
            self.spans.open("step")
            t_step = time.perf_counter()
            yield batch
        if t_step is not None:
            if sync:
                torch.cuda.synchronize()
            self.spans.times["step"].append(time.perf_counter() - t_step)
            self.spans.close("step")

    counted = 0
    steps = 0

    def trace_mode(self) -> None:
        self.traced = True
        to_device = self.trainer._to_device

        def timed(batch):
            with self.spans.span("to_device"):
                return to_device(batch)

        self.trainer._to_device = timed

    def replay_step(self, batch) -> None:
        """One train step on ``batch`` after the window (the traced run's
        count of the segment kernels' bytes)."""
        t = self.trainer
        t.state, _ = t._train_step(t.state, t._to_device(batch), t.generator)

    # -- window -----------------------------------------------------------------
    def window(self, seconds: float):
        self.counted = self.steps = 0
        self.spans.times["step"].clear()
        self.spans.times["loader_wait"].clear()
        t0 = time.perf_counter()
        self.trainer.train_epoch(self._fed(deadline=t0 + seconds))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        return ({"voxels": self.counted, "attempted": self.steps,
                 "failed": 0}, window_s)

    def window_flops(self) -> float:
        shapes = {k: tuple(v.shape) for k, v in self.init.items()}
        total = 0.0
        for batch, coords in self.window_batches:
            inp = inputs_from_batch(batch, coords, "cpu")
            graph = build_graph(inp["coords"], NUM_LEVELS)
            total += 3.0 * forward_flops(shapes, inp, graph)
        self.window_batches = []
        return total

    # -- after the window -----------------------------------------------------
    def release(self) -> None:
        self.close()
        self.trainer = self.model = self.optimizer = self.loader = None
        free_cuda()

    def check(self) -> Dict[str, float]:
        return train_checks(self.record, self.init, set(self.names),
                            recipe.hyper(self.cfg),
                            self.cfg["model"]["num_groups"], self.device,
                            stated_precision(self.cfg))

    def close(self) -> None:
        if self._batches is not None:
            self._batches.close()
