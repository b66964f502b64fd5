"""``eval``: the voting path that labels a scan.

Set-up builds the cell's synthetic areas from its ``data_seed`` as the
``loop`` traffic does (every ``--seed`` votes the same spheres, with
weights of its own), the port's eval dataset over them (its fixed grid of
sphere centres), a ``BatchLoader`` in order, the model with seeded weights
(eval mode: running statistics as built) and a vote accumulator, and runs
one eval step on the first batch (the bucket's one shape).  The window runs
``cli.eval``'s ``vote`` over the loader, pass after pass, until
``--seconds`` have passed: each batch through the port's eval step, its
logits voted per original point.  Counts: valid voxels voted.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..harness import recipe
from ..harness.checks import eval_checks, free_cuda, stated_precision
from ..harness.counts import forward_flops
from ..reference.graph import build_graph
from ..reference.model import NUM_LEVELS, inputs_from_batch

__all__ = ["Session"]


def _recording_votes(num_classes):
    from deepviewagg_tpu_torch.metrics.tracker import VoteAccumulator

    class RecordingVotes(VoteAccumulator):
        """The port's accumulator, keeping a copy of every vote."""

        log = None

        def add(self, cloud, size, origin_ids, logits):
            self.log.append((cloud, np.array(origin_ids),
                             np.array(logits, np.float32)))
            super().add(cloud, size, origin_ids, logits)

    votes = RecordingVotes(num_classes)
    votes.log = []
    return votes


class Session:
    training = False
    optimizer = None

    def __init__(self, cfg: Dict, params: Dict, seed: int, device, spans,
                 workdir: str):
        self.cfg, self.params, self.seed = cfg, params, int(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.workdir = workdir
        self.traced = False

    def setup(self) -> None:
        from deepviewagg_tpu_torch.data.collate import (batch_to_torch,
                                                        device_view)
        from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
        from deepviewagg_tpu_torch.metrics.tracker import SegmentationTracker
        from deepviewagg_tpu_torch.train.step import make_eval_step

        with self.spans.span("setup_data"):
            self.rc, ds, bucket = recipe.cell_data(
                self.cfg, self.params, self.workdir, self.device,
                train=False)
        self.data = recipe.RecordingDataset(ds)
        n_cls = self.cfg["model"]["num_classes"]
        with self.spans.span("setup_model"):
            self.spec, self.model, self.init = recipe.build_model(
                self.rc, n_cls, self.seed, self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.loader = BatchLoader(self.data, bucket, self.rc.data.batch_size,
                                  [0], shuffle=False,
                                  conv0_kernel=self.spec.stem_kernel)
        self.votes = _recording_votes(n_cls)
        self.tracker = SegmentationTracker(n_cls, "test")
        sizes = {}
        for i in range(len(ds.areas)):
            sizes[ds.areas.paths[i]] = len(ds.areas.get(i)["pos"])
        self.cloud_size = sizes.__getitem__
        # the bucket's shape, once, outside the window
        it = iter(self.loader)
        try:
            first = next(it)
        finally:
            it.close()
        self.data.coords.clear()
        make_eval_step(self.model)(None, batch_to_torch(device_view(first),
                                                        self.device))

    def trace_mode(self) -> None:
        self.traced = True

    def _passes(self, deadline):
        """Batches of pass after pass over the loader until the deadline;
        the votes each batch left are marked by their place in the log."""
        sync = self.traced and self.device.type == "cuda"
        self.marks = []       # (position in pass, first log row, batch)
        t_step = None

        def close_step():
            if t_step is not None:
                if sync:
                    torch.cuda.synchronize()
                self.spans.times["eval_step"].append(
                    time.perf_counter() - t_step)
                self.spans.close("eval_step")

        while time.perf_counter() < deadline:
            it = iter(self.loader)
            try:
                pos = 0
                while time.perf_counter() < deadline:
                    close_step()
                    t_step = None
                    with self.spans.span("loader_wait"):
                        batch = next(it, None)
                    if batch is None:
                        break
                    coords = self.data.take(batch)
                    self.marks.append((pos, len(self.votes.log), batch,
                                       coords))
                    pos += 1
                    self.spans.open("eval_step")
                    t_step = time.perf_counter()
                    yield batch
            finally:
                it.close()
                # samples the closed pass prefetched and never yielded
                self.data.coords.clear()
        close_step()

    def window(self, seconds: float):
        from deepviewagg_tpu_torch.cli.eval import vote

        class Passes:
            def __iter__(inner):
                return self._passes(deadline)

        t0 = time.perf_counter()
        deadline = t0 + seconds
        vote(self.model, Passes(), 1, self.device, self.tracker, self.votes,
             self.cloud_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        voxels = sum(int(b["meta"]["num_valid"]) for _, _, b, _ in self.marks)
        ends = [m[1] for m in self.marks[1:]] + [len(self.votes.log)]
        failed = sum(
            not all(np.isfinite(lg).all() for _, _, lg in
                    self.votes.log[start:end])
            for (_, start, _, _), end in zip(self.marks, ends))
        return ({"voxels": voxels, "attempted": len(self.marks),
                 "failed": failed}, window_s)

    def window_flops(self) -> float:
        shapes = {k: tuple(v.shape) for k, v in self.init.items()}
        cache = {}
        total = 0.0
        for pos, _, batch, coords in self.marks:
            if pos not in cache:
                inp = inputs_from_batch(batch, coords, "cpu")
                cache[pos] = forward_flops(
                    shapes, inp, build_graph(inp["coords"], NUM_LEVELS))
            total += cache[pos]
        return total

    def release(self) -> None:
        self.model = self.loader = None
        free_cuda()

    def samples(self):
        """Batches drawn from the seed among the places of a pass that the
        window ran, with the program's logits of each time it ran them."""
        ends = [m[1] for m in self.marks[1:]] + [len(self.votes.log)]
        ran = sorted({m[0] for m in self.marks})
        rng = np.random.default_rng(self.seed)
        sampled = set(rng.choice(ran, size=min(self.params["check_batches"],
                                               len(ran)),
                                 replace=False).tolist()) if ran else set()
        samples = {}
        for (pos, start, batch, coords), end in zip(self.marks, ends):
            if pos not in sampled:
                continue
            s = samples.setdefault(pos, {"batch": batch, "coords": coords,
                                         "logits": []})
            s["logits"].append(np.concatenate(
                [lg for _, _, lg in self.votes.log[start:end]]))
        return list(samples.values())

    def check(self) -> Dict[str, float]:
        samples = self.samples()
        out = eval_checks(samples, self.init, set(self.names),
                          self.cfg["model"]["num_groups"], self.device,
                          self.votes, self.votes.log,
                          stated_precision(self.cfg))
        out["batches_compared"] = float(len(samples))
        return out

    def close(self) -> None:
        pass
