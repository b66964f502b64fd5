"""The PTv3 cell's limits turn its control and its planted faults into
``correct: false``: the readings of :mod:`benchmark.calibrate_ptv3` go
through the harness's own ``verdict`` against the limits of
``workloads/s3dis-ptv3-train-resident.json``.

On the CPU the cell runs at a size it holds (``PTv3Test``: two levels,
width 16 and 32, patches of 8; three crops of 403 points at 10 cm, so that
each crop's last patch is short of 8), under the cell's own limits: the
sound run passes them, and the control (the reference one precision step
below the stated one), half of each batch left out of the loss, every
block attending in the first order and each sample's last patch left short
fail them.  On the card (marker ``card``) the same holds at the cell's own
size."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate_ptv3 as CP
from benchmark import run as R
from benchmark.tests import tiny

CELL = "s3dis-ptv3-train-resident"
FAULTS = ("control", "half_batch", "order0", "short_patch")
POINTS, CROPS = 403, 3


def _limits():
    return R.load_json(R.BENCH_DIR, "workloads", CELL + ".json")["limits"]


def _write(dest: str) -> str:
    """The PTv3 cell at the CPU's size under ``dest``, with the cell's
    limits; returns its benchmark directory."""
    from deepviewagg_tpu_torch.nn.ptv3 import PTV3_PRESETS

    d = os.path.join(dest, "benchmark")
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(d, sub))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), dest)
    cell = R.find_cell(R.load_bench(), CELL)
    cfg = R.load_json(R.BENCH_DIR, "configs", cell["config"] + ".json")
    arch = cfg["model"]["arch"]
    for key, value in dataclasses.asdict(PTV3_PRESETS["PTv3Test"]).items():
        if key in arch:
            arch[key] = list(value) if isinstance(value, tuple) else value
    arch["stride"] = arch["stride"][:len(arch["dec_depths"])]
    cfg["model"]["overrides"] = {"backbone": "PTv3Test"}
    cfg["data"].update(voxel_size=0.1, point_max=POINTS, batch_size=CROPS)
    with open(os.path.join(d, "configs", cell["config"] + ".json"),
              "w") as f:
        json.dump(cfg, f)
    w = R.load_json(R.BENCH_DIR, "workloads", CELL + ".json")
    w["scene"] = {"n_areas": 1, "density": 100.0, "n_cameras": 0}
    w["bucket"]["level_caps"] = [CROPS * POINTS] * len(arch["enc_depths"])
    with open(os.path.join(d, "workloads", CELL + ".json"), "w") as f:
        json.dump(w, f)
    return d


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    from benchmark.harness.trace import Spans

    root = str(tmp_path_factory.mktemp("ptv3_cal"))
    bench_dir = _write(root)
    torch.set_num_threads(2)
    _, cfg, params, traffic = R.load_cell(R.load_bench(root), CELL,
                                          bench_dir=bench_dir)
    workdir = os.path.join(root, "work")
    os.makedirs(workdir)
    session = traffic.Session(cfg, params, 2147483999, "cpu", Spans(False),
                              workdir)
    session.setup()
    n0 = [int(sum(b["graph"]["counts"][0])) for b in session.pool]
    session.release()
    out = CP.readings(session, ("control", "half", "order0", "short_patch"))
    return n0, out


def test_the_crops_leave_a_short_last_patch(readings):
    n0, _ = readings
    # each crop holds POINTS points, not a whole number of patches of 8
    assert n0 == [CROPS * POINTS] * len(n0) and POINTS % 8


def test_the_sound_run_passes_the_cells_limits(readings):
    ok, table = R.verdict(readings[1]["program"], _limits())
    assert ok, table


@pytest.mark.parametrize("fault", FAULTS)
def test_the_control_and_each_fault_fail_the_cells_limits(readings, fault):
    ok, table = R.verdict(readings[1][fault], _limits())
    assert not ok, table


@pytest.mark.card
def test_the_control_and_each_fault_fail_at_the_cells_size(card):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate_ptv3", "--workload",
         CELL, "--seeds", "2147483661", "--runs", "control", "half",
         "order0", "short_patch"], cwd=tiny.ROOT, capture_output=True,
        text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert R.verdict(out["program"], _limits())[0], out["program"]
    for fault in FAULTS:
        assert not R.verdict(out[fault], _limits())[0], (fault, out[fault])
