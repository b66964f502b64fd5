"""The experiment loop with ``training.data_parallel=true``:
``cli.train --device cpu`` in two spawned ranks under a torchrun-style
environment (``torch_port_parallel.Ranks``, gloo), on ``conf/synthetic.yaml``
cut to a few batches, then resumed; and a world of one against the plain
loop.

The batch assignment is the JAX CLI's ``chunk_per_device``: rank ``r``
trains on the loader's batches ``i`` with ``i % 2 == r``, the odd batch
dropped on both.  Rank 0 alone writes checkpoints; both ranks end every run
with the same bytes in every parameter and buffer; every rank resumes from
the saved state bit for bit.  A world of one (no launcher, ``--device cpu``)
is bit-identical to the plain loop: the same losses, metrics and
checkpoint.
"""

import json
import os

import pytest
import torch

from deepviewagg_tpu_torch.cli import train as cli
from torch_port_parallel import Ranks
from torch_port_util import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(tmp_path, *extra):
    return ["--config", "conf/synthetic.yaml", "--device", "cpu",
            "training.epochs=1", "data.samples_per_epoch=6",
            f"data.root={tmp_path / 'data'}",
            f"training.run_dir={tmp_path / 'run'}",
            "training.tensorboard=false", "data.image_size=[64, 32]",
            "model.overrides={backbone: Res16UNetTest}",
            "data.kwargs={n_areas: 1, density: 30.0, n_cameras: 2}", *extra]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    inputs = {"loop_args": _args(tmp, "training.data_parallel=true"),
              "run_dir": str(tmp / "run")}
    got = Ranks(2, ["loop"], tmp, inputs, timeout=300).wait()["loop"]
    return got, tmp


def test_ranks_take_chunk_per_device_batches(loop):
    got, _ = loop
    loaded = got[0]["loaded"]
    assert got[1]["loaded"] == loaded and len(loaded) == 2 * 3  # 2 runs
    for run in range(2):
        epoch = loaded[3 * run:3 * run + 3]
        for r in range(2):
            # 3 batches for 2 ranks: batch 2 is dropped on both
            assert got[r]["stepped"][run] == epoch[r]
    assert len(got[0]["stepped"]) == len(got[1]["stepped"]) == 2
    assert got[0]["metrics"]["train_batches"] == 1


def test_primary_alone_writes_the_checkpoint(loop):
    got, tmp = loop
    assert "latest" in got[0]["saved"] and got[1]["saved"] == []
    run = tmp / "run"
    assert {"latest.pt", "run.json", "best.json", "metrics.jsonl"} <= set(
        os.listdir(run))
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all("val_miou" in r for r in records)
    assert torch.load(run / "latest.pt", weights_only=True)["step"] == 2


def test_ranks_hold_the_same_parameters_and_resume_bit_equal(loop):
    got, _ = loop
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["digest"][0] != got[0]["digest"][1]     # the resume trained
    assert got[0]["restored"] == got[1]["restored"] == [True]
    # both ranks report the same metrics (confusion summed over the ranks)
    assert got[0]["metrics"] == {**got[1]["metrics"], "train_time_s":
                                 got[0]["metrics"]["train_time_s"]}


def test_world_of_one_is_bit_identical_to_the_plain_loop(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(ROOT)
    runs = {}
    for name, extra in (("plain", ()), ("dp", ("training.data_parallel=true",))):
        args = _args(tmp_path, f"training.run_dir={tmp_path / name}", *extra)
        runs[name] = cli.main(args)
        assert not torch.distributed.is_initialized()
    runs["plain"].pop("train_time_s"), runs["dp"].pop("train_time_s")
    assert runs["plain"] == runs["dp"]
    a, b = (torch.load(tmp_path / n / "latest.pt", weights_only=True)
            for n in ("plain", "dp"))
    assert a["step"] == b["step"] == 3
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for ga, gb in zip(a["optimizer"]["groups"], b["optimizer"]["groups"]):
        assert all(torch.equal(x, y) for k in ga for x, y in zip(ga[k], gb[k]))
