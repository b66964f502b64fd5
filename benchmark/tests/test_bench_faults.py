"""The harness drives a whole run on the CPU (its look for a card left
out) with the timed path broken underneath, and ``correct`` comes out
false: a step that leaves the state unchanged, half of the batch left out
of the loss, a segment kernel's backward that returns zeros (the image
branch alone then learns nothing), an answer altered where it is produced,
a vote altered where it is accumulated.  The unbroken run comes out
correct."""

import pytest
import torch

from benchmark import run as R
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


def _correct(bench_dir, cell):
    run, checks = tiny.execute(bench_dir, cell)
    return R.verdict(checks, run.params["limits"])[0], checks


def test_sound_training_run_is_correct(bench_dir):
    ok, checks = _correct(bench_dir, "s3dis-l4-train-resident")
    assert ok, checks


def test_a_step_that_leaves_the_state_unchanged(bench_dir, monkeypatch):
    from deepviewagg_tpu_torch.train.optimizers import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self: True)
    ok, checks = _correct(bench_dir, "s3dis-l4-train-resident")
    assert not ok and checks["update_gap_part"] > 0.9


def test_half_of_the_batch_left_out(bench_dir, monkeypatch):
    import deepviewagg_tpu_torch.train.step as step

    loss = step.segmentation_loss

    def half(logits, labels, valid, *a):
        keep = valid & (torch.arange(valid.shape[0]) % 2 == 0)
        return loss(logits, labels, keep, *a)

    monkeypatch.setattr(step, "segmentation_loss", half)
    ok, checks = _correct(bench_dir, "s3dis-l4-train-resident")
    assert not ok, checks


def test_a_segment_backward_that_returns_zeros(bench_dir, monkeypatch):
    import deepviewagg_tpu_torch.ops.segment as seg

    bwd = seg.segment_csr_bwd

    def zeros(*args, **kwargs):
        return torch.zeros_like(bwd(*args, **kwargs))

    monkeypatch.setattr(seg, "segment_csr_bwd", zeros)
    ok, checks = _correct(bench_dir, "s3dis-l4-train-resident")
    assert not ok and checks["grad_gap_part"] > 0.9, checks


def test_an_answer_altered_where_it_is_produced(bench_dir, monkeypatch):
    import deepviewagg_tpu_torch.cli.eval as cli_eval

    make = cli_eval.make_eval_step

    def altered(model, mc_dropout=False):
        step = make(model, mc_dropout)

        def run(state, batch, generator=None):
            out = step(state, batch, generator)
            logits = out["logits"].clone()
            logits[::50] = logits[::50].flip(-1)
            return {**out, "logits": logits,
                    "preds": logits.argmax(dim=-1)}

        return run

    monkeypatch.setattr(cli_eval, "make_eval_step", altered)
    ok, checks = _correct(bench_dir, "s3dis-l4-eval-voting")
    assert not ok and checks["logit_rms_rel"] > 3.0, checks


def test_a_vote_altered_where_it_is_accumulated(bench_dir, monkeypatch):
    import numpy as np

    from deepviewagg_tpu_torch.metrics.tracker import VoteAccumulator

    add = VoteAccumulator.add

    def halved(self, cloud, size, ids, logits):
        return add(self, cloud, size, ids, np.asarray(logits) * 0.5)

    monkeypatch.setattr(VoteAccumulator, "add", halved)
    ok, checks = _correct(bench_dir, "s3dis-l4-eval-voting")
    assert not ok and checks["vote_err"] > 0
