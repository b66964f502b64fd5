"""Spawned gloo ranks for the ``test_torch_port_parallel_*`` tests.

The test process writes its inputs (numpy variables and batches) to
``<tmp>/inputs.pkl`` and starts ``world`` processes of this file
(:class:`Ranks`) under a torchrun-style environment; each joins a gloo
group, runs the named scenarios on the CPU and writes
``<tmp>/<scenario>_rank<r>.pkl``.  A rank that fails ends the others at
once, and the whole run is bounded by a timeout.  The ranks import torch
and the port only; the JAX references run in the test process meanwhile.

Run by hand: ``RANK=0 WORLD_SIZE=1 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500
python tests/torch_port_parallel.py collectives <tmp>``.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import hashlib
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TINY_SPEC = dict(backbone="Res16UNetTest", tower="resnet18_l1", num_groups=2)
OPT = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=10.0)
LR = 0.1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` processes of this file running ``scenarios`` in one gloo
    group; :meth:`wait` returns each scenario's per-rank results."""

    def __init__(self, world: int, scenarios, tmp: Path, inputs=None,
                 timeout: float = 240.0):
        self.world, self.scenarios, self.tmp = world, list(scenarios), tmp
        self.timeout = timeout
        if inputs is not None:
            with open(tmp / "inputs.pkl", "wb") as f:
                pickle.dump(inputs, f)
        port = free_port()
        self.logs, self.procs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            log = open(tmp / f"rank{r}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, ",".join(self.scenarios),
                 str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT)))
        self.start = time.time()

    def wait(self) -> dict:
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = any(c not in (None, 0) for c in codes)
                late = time.time() - self.start > self.timeout
                if failed or late:
                    raise AssertionError(
                        f"ranks {'failed' if failed else 'timed out'} "
                        f"(exit codes {codes}):\n" + self._tails())
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        out = {}
        for name in self.scenarios:
            out[name] = []
            for r in range(self.world):
                with open(self.tmp / f"{name}_rank{r}.pkl", "rb") as f:
                    out[name].append(pickle.load(f))
        return out

    def _tails(self) -> str:
        return "\n".join(
            f"--- rank {r} ---\n"
            + (self.tmp / f"rank{r}.log").read_text()[-3000:]
            for r in range(self.world))


# --- the ranks -----------------------------------------------------------------

def digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes, in order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def f32_sparse_convs_port():
    """The port's half of ``torch_port_util.f32_sparse_convs``: the sparse
    convolutions with float32 operands."""
    from deepviewagg_tpu_torch.nn import sparse_blocks as tb

    plain, subm, pair = (tb.sparse_conv, tb.sparse_conv_submanifold,
                         tb.sparse_conv_pair)
    tb.sparse_conv = lambda f, w, n, bias=None, compute_dtype=None: plain(
        f, w, n, bias, torch.float32)
    tb.sparse_conv_submanifold = lambda f, w, n, cd=None: subm(
        f, w, n, torch.float32)
    tb.sparse_conv_pair = lambda f, w, n, nt, cd=None: pair(
        f, w, n, nt, torch.float32)


def tiny_spec(**branch):
    from deepviewagg_tpu_torch.data.toy import flagship_spec

    spec = flagship_spec(**TINY_SPEC)
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, tower_bf16=False, **branch))
        for lvl, b in spec.branches))


def port_model(variables, **branch):
    from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
    from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables

    model = MultimodalSeg(tiny_spec(**branch), device="cpu", seed=None)
    load_flax_variables(model, variables)
    return model


def run_steps(model, batch, steps: int, group=None, wrap=None,
              generator=None):
    """``steps`` SGD steps of ``make_train_step(model, group=group)``
    (wrapped by ``wrap``): the metrics and the model's flax trees after
    each step, the last trees and the digest of the model after them."""
    from deepviewagg_tpu_torch.data.collate import batch_to_torch
    from deepviewagg_tpu_torch.train import optimizers as topt
    from deepviewagg_tpu_torch.train.step import TrainState, make_train_step
    from deepviewagg_tpu_torch.utils.from_jax import to_flax_tree

    state = TrainState.create(model, topt.make_optimizer(
        topt.make_schedule("constant", LR), **OPT))
    step = make_train_step(model, group=group)
    if wrap is not None:
        step = wrap(step)
    tb = batch_to_torch(batch, "cpu")
    metrics, trees = [], []
    for _ in range(steps):
        state, m = step(state, tb, generator)
        metrics.append({k: v.detach().numpy().copy() for k, v in m.items()})
        # copies: the trees' arrays share the CPU tensors' memory
        trees.append(copy.deepcopy({
            "params": to_flax_tree(model, "params"),
            "batch_stats": to_flax_tree(model, "batch_stats")}))
    return {"metrics": metrics, "steps": trees, **trees[-1],
            "digest": digest(model)}


def scenario_collectives(inputs, rank, world):
    """The collectives, the mesh, multihost and sync BN on seeded data."""
    import torch.distributed as dist

    from deepviewagg_tpu_torch.nn.norm import MaskedBatchNorm, bn_process_group
    from deepviewagg_tpu_torch.parallel import collectives as col
    from deepviewagg_tpu_torch.parallel import mesh as pmesh
    from deepviewagg_tpu_torch.parallel import multihost

    out = {}
    rng = np.random.default_rng(10 + rank)
    x = torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32)
    y = col.all_reduce_sum(x)
    (y * w).sum().backward()
    out["sum"] = (y.detach().numpy(), x.grad.numpy())

    xg = torch.tensor(rng.normal(size=(2, 3, 4)), dtype=torch.float32,
                      requires_grad=True)
    wg = torch.tensor(rng.normal(size=(2 * world, 3, 4)), dtype=torch.float32)
    yg = col.all_gather_blocks(xg)
    (yg * wg).sum().backward()
    out["gather"] = (yg.detach().numpy(), xg.grad.numpy())

    ts = [torch.tensor(rng.normal(size=s), dtype=dt) for s, dt in (
        ((7,), torch.float32), ((3, 5), torch.float32),
        ((4,), torch.float64), ((1000,), torch.float32))]
    before = [t.clone().numpy() for t in ts]
    col.all_reduce_mean_(ts, bucket_bytes=64)
    out["mean"] = (before, [t.numpy() for t in ts])
    tb = [torch.full((3,), float(rank)), torch.full((2, 2), float(rank))]
    col.broadcast_(tb, src=1)
    out["broadcast"] = [t.numpy() for t in tb]

    out["primary"] = multihost.is_primary()
    samples = [{"x": np.full((4,), float(i), np.float32)} for i in range(8)]
    mine = list(multihost.HostShardedLoader(lambda: iter(samples)))
    out["shard"] = [int(b["x"][0]) for b in mine]
    total = torch.tensor([float(sum(b["x"].sum() for b in mine))])
    dist.all_reduce(total)
    out["total"] = float(total)

    mesh = pmesh.make_hybrid_mesh(2)
    out["hybrid_mesh"] = (mesh.n_data, mesh.n_model, mesh.data_rank,
                          mesh.model_rank,
                          dist.get_process_group_ranks(mesh.data_group),
                          dist.get_process_group_ranks(mesh.model_group))
    flat = pmesh.make_mesh()
    out["mesh"] = (flat.n_data, flat.n_model, flat.data_rank,
                   flat.data_group is dist.group.WORLD)

    # sync BN: this rank's rows of a batch norm's input
    rows = inputs["bn_rows"][rank]
    valid = torch.tensor(inputs["bn_valid"][rank])
    bn = MaskedBatchNorm(rows.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(inputs["bn_weight"]))
    xb = torch.tensor(rows, requires_grad=True)
    with bn_process_group(dist.group.WORLD):
        yb = bn(xb, valid)
    (yb * torch.tensor(inputs["bn_cot"][rank])).sum().backward()
    out["bn"] = (yb.detach().numpy(), xb.grad.numpy(),
                 bn.weight.grad.numpy(), bn.running_mean.numpy(),
                 bn.running_var.numpy())
    return out


def scenario_steps(inputs, rank, world):
    """Each case of ``inputs["cases"]``: this rank's batch through
    ``steps`` steps of the data-parallel (``n_model`` 1) or hybrid step."""
    from deepviewagg_tpu_torch.parallel import mesh as pmesh

    out = {}
    for case in inputs["cases"]:
        n_model = case.get("n_model", 1)
        mesh = (pmesh.make_hybrid_mesh(n_model) if n_model > 1
                else pmesh.make_mesh())
        model = port_model(case["variables"], **case.get("branch", {}))
        pmesh.replicate(model, mesh)
        if n_model > 1:
            res = run_steps(model, case["batches"][mesh.data_rank],
                            case["steps"], mesh.world,
                            lambda s: pmesh.hybrid_parallel_step(s, mesh))
        else:
            res = run_steps(model, case["batches"][mesh.data_rank],
                            case["steps"], mesh.data_group,
                            lambda s: pmesh.data_parallel_step(s, mesh))
        out[case["name"]] = res
    return out


def loss_grads(model, batch):
    """``model`` after the backward pass of one training-mode loss."""
    from deepviewagg_tpu_torch.data.collate import batch_to_torch
    from deepviewagg_tpu_torch.models.losses import segmentation_loss

    tb = batch_to_torch(batch, "cpu")
    model.train()
    out = model(tb)
    segmentation_loss(out["logits"], tb["labels"],
                      tb["graph"]["levels"][0]["valid"]).backward()
    return model


def trunk(seed: int = 0):
    """A small ConvDown2D (two taps) with seeded weights."""
    from deepviewagg_tpu_torch.modules.image_encoders import ConvDown2D

    t = ConvDown2D(widths=(8, 16), blocks=(1, 1), strides=(1, 2))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in t.parameters():
            p.copy_(torch.tensor(rng.normal(0.0, 0.3, p.shape)))
    return t


def scenario_shard(inputs, rank, world):
    """View sharding over the model groups of a 2 x 2 mesh, every rank on
    the same batch: the gradients (mean over the model group) with the
    tower sharded under each remat mode, and a shared trunk's taps."""
    import torch.distributed as dist

    from deepviewagg_tpu_torch.modules.image_encoders import (
        run_tower, view_shard_group)
    from deepviewagg_tpu_torch.parallel import mesh as pmesh
    from deepviewagg_tpu_torch.parallel.collectives import all_reduce_mean_
    from deepviewagg_tpu_torch.utils.from_jax import to_flax_tree

    mesh = pmesh.make_hybrid_mesh(2)
    out = {"groups": dist.get_process_group_ranks(mesh.model_group)}
    for remat in (False, "convs"):
        model = port_model(inputs["variables"], remat_tower=remat)
        with view_shard_group(mesh.model_group):
            loss_grads(model, inputs["batch"])
        grads = [p.grad for p in model.parameters()]
        all_reduce_mean_(grads, mesh.model_group)
        out[f"grads_{remat}"] = to_flax_tree(model, "grads")
    images = torch.tensor(inputs["images"])
    with view_shard_group(mesh.model_group):
        out["taps"] = [t.detach().numpy() for t in run_tower(
            trunk(), images, False, bf16=False)]
        frozen = port_model(inputs["variables"], frozen=True)
        frozen.train()
        from deepviewagg_tpu_torch.data.collate import batch_to_torch
        out["frozen_logits"] = frozen(batch_to_torch(
            inputs["batch"], "cpu"))["logits"].detach().numpy()
    return out


def fingerprint(labels) -> str:
    return hashlib.sha1(np.ascontiguousarray(labels).tobytes()).hexdigest()


def scenario_loop(inputs, rank, world):
    """``cli.train.main`` with ``training.data_parallel=true`` (this rank
    joins the group already up), then again with ``training.resume=true``:
    the train batches the loader made and the ones this rank's steps took,
    the checkpoint keys this rank wrote, the model's digest after each run,
    and whether the resumed state equals the saved one bit for bit."""
    from deepviewagg_tpu_torch.cli import train as cli
    from deepviewagg_tpu_torch.data.datasets import base
    from deepviewagg_tpu_torch.train import checkpoint, trainer

    out = {"loaded": [], "stepped": [], "saved": [], "digest": [],
           "restored": []}
    run_dir = Path(inputs["run_dir"])
    live = {}
    orig_iter = base.BatchLoader.__iter__
    orig_step = trainer.make_train_step
    orig_save = checkpoint.CheckpointManager.save_state
    orig_init = trainer.Trainer.__init__
    orig_fit = trainer.Trainer.fit

    def loader_iter(loader):
        for batch in orig_iter(loader):
            if loader.dataset.train:
                out["loaded"].append(fingerprint(batch["labels"]))
            yield batch

    def make_train_step(*args, **kwargs):
        step = orig_step(*args, **kwargs)

        def run(state, batch, generator):
            out["stepped"].append(fingerprint(batch["labels"].numpy()))
            return step(state, batch, generator)
        return run

    def save_state(self, key, state):
        out["saved"].append(key)
        return orig_save(self, key, state)

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        live["trainer"] = self

    def fit(self, *args, **kwargs):
        if live.get("resume"):
            saved = torch.load(run_dir / "latest.pt", weights_only=True)
            tx = self.state.tx.state_dict()
            same = all(torch.equal(v, saved["model"][k])
                       for k, v in self.model.state_dict().items())
            same &= tx["count"] == saved["optimizer"]["count"]
            same &= self.state.step == saved["step"]
            for got, want in zip(tx["groups"], saved["optimizer"]["groups"]):
                same &= sorted(got) == sorted(want) and all(
                    torch.equal(a, b) for k in want
                    for a, b in zip(got[k], want[k]))
            out["restored"].append(bool(same))
        return orig_fit(self, *args, **kwargs)

    base.BatchLoader.__iter__ = loader_iter
    trainer.make_train_step = make_train_step
    checkpoint.CheckpointManager.save_state = save_state
    trainer.Trainer.__init__ = init
    trainer.Trainer.fit = fit
    out["metrics"] = cli.main(inputs["loop_args"])
    out["digest"].append(digest(live["trainer"].model))
    live["resume"] = True
    cli.main(inputs["loop_args"] + ["training.resume=true"])
    out["digest"].append(digest(live["trainer"].model))
    return out


SCENARIOS = {"collectives": scenario_collectives, "steps": scenario_steps,
             "shard": scenario_shard, "loop": scenario_loop}


def main() -> None:
    import torch.distributed as dist

    from deepviewagg_tpu_torch.parallel import multihost

    names, tmp = sys.argv[1].split(","), Path(sys.argv[2])
    torch.set_num_threads(1)
    inputs = None
    if (tmp / "inputs.pkl").exists():
        with open(tmp / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
    f32_sparse_convs_port()
    from deepviewagg_tpu_torch.modules.image_encoders import f32_convs

    multihost.initialize(device="cpu",
                         timeout=datetime.timedelta(seconds=120))
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        with f32_convs():
            for name in names:
                res = SCENARIOS[name](inputs, rank, world)
                with open(tmp / f"{name}_rank{rank}.pkl", "wb") as f:
                    pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
