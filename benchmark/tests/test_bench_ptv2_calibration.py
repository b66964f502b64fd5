"""The PTv2 cell's limits turn its control and its planted faults into
``correct: false``: the readings of :mod:`benchmark.calibrate_ptv2` go
through the harness's own ``verdict`` against the limits of
``workloads/s3dis-ptv2-train-resident.json``.

On the CPU the cell runs at a size it holds (``PTv2Test``: two stages,
widths 8 to 24, tables of 4 and 8; three crops of 403 points at 10 cm,
whose level 2 holds fewer than 8 points a crop, so that the mask after the
softmax has slots to mask), under the cell's own limits: the sound run
passes them, and the control (the reference one precision step below the
stated one), neighbours searched across samples, the positional bias left
out of the value path and the mask left off fail them (the mask by the
loss: its logits move less than the limit, which the card's sound runs
set), as do no gradient through the grid pooling's maximum, the
parameters left unchanged by the optimizer and the second half of each
batch's samples left out of the loss.  On the card (marker ``card``) the
same holds at the cell's own size for the control, the first two faults,
no gradient through the pooling and the unchanged parameters; the mask
changes nothing there where every level of a crop of 102,400 points holds
16 points or more."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate_ptv2 as CP
from benchmark import run as R
from benchmark.tests import tiny

CELL = "s3dis-ptv2-train-resident"
FAULTS = ("control", "cross_sample", "no_peb_value", "no_mask",
          "no_pool_grad", "frozen", "half")
CARD_FAULTS = ("control", "cross_sample", "no_peb_value", "no_pool_grad",
               "frozen")
POINTS, CROPS = 403, 3


def _limits():
    return R.load_json(R.BENCH_DIR, "workloads", CELL + ".json")["limits"]


def _write(dest: str) -> str:
    """The PTv2 cell at the CPU's size under ``dest``, with the cell's
    limits; returns its benchmark directory."""
    from deepviewagg_tpu_torch.nn.ptv2 import PTV2_PRESETS

    d = os.path.join(dest, "benchmark")
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(d, sub))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), dest)
    cell = R.find_cell(R.load_bench(), CELL)
    cfg = R.load_json(R.BENCH_DIR, "configs", cell["config"] + ".json")
    arch = cfg["model"]["arch"]
    for key, value in dataclasses.asdict(PTV2_PRESETS["PTv2Test"]).items():
        if key in arch:
            arch[key] = list(value) if isinstance(value, tuple) else value
    cfg["model"]["overrides"] = {"backbone": "PTv2Test"}
    cfg["data"].update(voxel_size=0.1, point_max=POINTS, batch_size=CROPS)
    with open(os.path.join(d, "configs", cell["config"] + ".json"),
              "w") as f:
        json.dump(cfg, f)
    w = R.load_json(R.BENCH_DIR, "workloads", CELL + ".json")
    w["scene"] = {"n_areas": 1, "density": 100.0, "n_cameras": 0}
    w["bucket"]["level_caps"] = [CROPS * POINTS + 17]
    with open(os.path.join(d, "workloads", CELL + ".json"), "w") as f:
        json.dump(w, f)
    return d


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    from benchmark.harness.trace import Spans

    root = str(tmp_path_factory.mktemp("ptv2_cal"))
    bench_dir = _write(root)
    torch.set_num_threads(2)
    _, cfg, params, traffic = R.load_cell(R.load_bench(root), CELL,
                                          bench_dir=bench_dir)
    workdir = os.path.join(root, "work")
    os.makedirs(workdir)
    session = traffic.Session(cfg, params, 2147483999, "cpu", Spans(False),
                              workdir)
    session.setup()
    counts = [d[2] for step in session.record.draws for d in step
              if d[0] == "level"]
    session.release()
    return counts, CP.readings(session, FAULTS)


def test_a_crop_holds_fewer_points_than_a_table_at_level_two(readings):
    counts, _ = readings
    assert counts and any(min(c) < 8 for c in counts)


def test_the_sound_run_passes_the_cells_limits(readings):
    ok, table = R.verdict(readings[1]["program"], _limits())
    assert ok, table


@pytest.mark.parametrize("fault", FAULTS)
def test_the_control_and_each_fault_fail_the_cells_limits(readings, fault):
    ok, table = R.verdict(readings[1][fault], _limits())
    assert not ok, table


@pytest.mark.card
def test_the_control_and_four_faults_fail_at_the_cells_size(card):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate_ptv2", "--workload",
         CELL, "--seeds", "2147483661", "--runs", *CARD_FAULTS],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert R.verdict(out["program"], _limits())[0], out["program"]
    for fault in CARD_FAULTS:
        assert not R.verdict(out[fault], _limits())[0], (fault, out[fault])
