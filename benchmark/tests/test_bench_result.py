"""The result line, the refusal without a card, and BENCHMARK.json's
shape."""

import json
import os
import re
import subprocess
import sys

from benchmark import run as R
from benchmark.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_result_line_has_exactly_its_keys(tmp_path):
    d = tiny.write(str(tmp_path))
    bench = R.load_bench(os.path.dirname(d))
    run, checks = tiny.execute(d, "s3dis-l4-eval-voting")
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "power_limit_w": 700.0}
    line = R.result_line(run, checks, bench, device, d)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    # no card: no peak of device memory to read
    assert set(line["metrics"]) == {"eval_voxels_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert set(line["checks"]) == set(tiny.EVAL_LIMITS)
    json.dumps(line)


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "s3dis-l4-train-loop", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_json_is_well_formed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in e.get("workloads", [cell])
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in b["workloads"])
