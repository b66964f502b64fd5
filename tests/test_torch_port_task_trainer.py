"""The port's ``TaskTrainer`` against the JAX package's over two batches,
and ``python -m deepviewagg_tpu_torch.cli.train_task --device cpu`` for
each task at the JAX script's settings (two batches).

The trainers run Adam at a constant learning rate with the gradients
clipped at 10 and no weight decay.  From the same parameters the epoch
metrics of two detection batches agree to 1e-4 relative: the detection
head has no sparse convolution and no dropout, so both packages compute the
same float32 function, in another summation order.
"""

import jax
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.datasets import tasks as JT
from deepviewagg_tpu.models import detection as jdet
from deepviewagg_tpu.train import task_steps as JS
from deepviewagg_tpu_torch.cli import train_task as cli
from deepviewagg_tpu_torch.models import detection as tdet
from deepviewagg_tpu_torch.train import task_steps as TS
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import _torch_threads  # noqa: F401

DET_SA = ((16, 32), (32, 64))
METRIC_RTOL = 1e-4


def test_task_trainer_matches_jax_over_two_batches():
    """Adam at a constant LR with clipping, as both trainers run it: two
    detection batches from the same parameters give the same epoch
    metrics."""
    ds = JT.make_detection_dataset(None, n_points=600, n_proposals=16)
    batches = [ds[0], ds[1]]
    jmodel = jdet.VoteNetDet(num_classes=2, sa_channels=DET_SA)
    jtrainer = JS.TaskTrainer(jmodel, JS.make_detection_step(jmodel),
                              base_lr=3e-3, log_fn=lambda s: None)
    jtrainer.init(JS.TaskTrainer._strip_meta(batches[0]), seed=0)
    variables = {"params": jax.device_get(jtrainer.state.params),
                 "batch_stats": jax.device_get(jtrainer.state.batch_stats)}
    want = jtrainer.fit(lambda: iter(batches), epochs=1)

    tmodel = tdet.VoteNetDet(2, sa_channels=DET_SA, device="cpu", seed=None)
    lines = []
    trainer = TS.TaskTrainer(tmodel, TS.make_detection_step(tmodel),
                             base_lr=3e-3, log_fn=lines.append, device="cpu")
    trainer.init(seed=0)
    load_flax_variables(tmodel, variables)
    got = trainer.fit(lambda: iter(batches), epochs=1)
    assert sorted(got) == sorted(want)
    assert got["batches"] == 2 and trainer.state.step == 2
    assert trainer.state.tx.count == 2
    for key in ("loss", "loss_vote", "loss_obj", "loss_box", "grad_norm"):
        assert abs(got[key] - want[key]) <= METRIC_RTOL * max(
            abs(want[key]), 1e-6), key
    assert len(lines) == 1 and lines[0].startswith("epoch 1: loss=")


def test_task_trainer_init_is_seeded():
    model = tdet.VoteNetDet(2, sa_channels=DET_SA, device="cpu", seed=None)
    trainer = TS.TaskTrainer(model, TS.make_detection_step(model),
                             device="cpu")
    trainer.init(seed=3)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.init(seed=3)
    assert all(torch.equal(first[k], v) for k, v in
               model.state_dict().items())
    ref = tdet.VoteNetDet(2, sa_channels=DET_SA, device="cpu", seed=3)
    assert all(torch.equal(first[k], v) for k, v in
               ref.state_dict().items())
    assert trainer.state.tx.optimizer == "adam"
    assert trainer.state.tx.weight_decay == 0.0
    assert trainer.state.tx.grad_clip == 10.0


@pytest.mark.parametrize("task", cli.TASKS)
def test_cli_train_task_on_the_cpu(task, capsys):
    metrics = cli.main(["--task", task, "--batches", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu allow_tf32_matmul=False")
    assert "\nepoch 1: loss=" in out and "\nfinal: {'loss': " in out
    assert metrics["batches"] == 2
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    assert metrics["loss"] > 0
