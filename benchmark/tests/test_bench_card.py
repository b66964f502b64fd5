"""On the card: one short run of each cell prints a correct result line,
and the control, at the cell's own size, fails the cell's limits (run with
``python -m pytest benchmark/tests -m card`` on a machine with a card)."""

import json
import subprocess
import sys

import pytest

from benchmark import run as R
from benchmark.tests import tiny

CELLS = [c["name"] for c in R.load_bench()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"], cwd=tiny.ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 1 and line["attempted"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate", "--workload", cell,
         "--seeds", "2147483661"], cwd=tiny.ROOT, capture_output=True,
        text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    limits = R.load_json(R.BENCH_DIR, "workloads", cell + ".json")["limits"]
    assert not R.verdict(out["control"], limits)[0]
    assert R.verdict(out["program"], limits)[0]
