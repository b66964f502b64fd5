"""A cell, a configuration and a metric are taken as files alone."""

import json
import os

from benchmark import run as R
from benchmark.tests import tiny


def test_new_cell_config_and_metric_are_found_without_an_edit(tmp_path):
    d = tiny.write(str(tmp_path))
    root = os.path.dirname(d)
    with open(os.path.join(d, "configs", tiny.S3DIS + ".json")) as f:
        cfg = json.load(f)
    cfg["name"] = "new-config"
    cfg["data"]["radius"] = 1.4
    with open(os.path.join(d, "configs", "new-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "workloads", "s3dis-l4-train-resident.json")) \
            as f:
        wl = json.load(f)
    with open(os.path.join(d, "workloads", "new-cell.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(d, "metrics", "pool_batches.new.py"), "w") as f:
        f.write('"""Batches in the window."""\n\n\ndef read(run):\n'
                '    return float(run.counters["attempted"])\n')
    bench = R.load_bench(root)
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "benchmark/configs/new-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "resident.small", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "pool_batches.new", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step and eval step",
                               "moves": "train_voxels_per_s",
                               "workloads": ["new-cell"]})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell, cfg2, params, traffic = R.load_cell(R.load_bench(root), "new-cell",
                                              d)
    assert cfg2["name"] == "new-config" and traffic.__name__.endswith(
        ".resident")
    names = [m["name"] for m in R.cell_metrics(bench, cell, True)]
    assert "pool_batches.new" in names
    assert [m["name"] for m in R.cell_metrics(bench, cell, False)] == [
        "train_voxels_per_s", "peak_mem_gib", "setup_s"]

    run, checks = tiny.execute(d, "new-cell")
    assert run.counters["attempted"] > 0
    got = R.read_metrics(run, [m for m in bench["per_layer"]
                               if m["name"] == "pool_batches.new"], d)
    assert got == {"pool_batches.new": {
        "value": float(run.counters["attempted"]), "unit": "1"}}
    assert R.verdict(checks, params["limits"])[0]


def test_each_cell_has_its_files():
    bench = R.load_bench()
    for cell in bench["workloads"]:
        c, cfg, params, traffic = R.load_cell(bench, cell["name"])
        assert hasattr(traffic, "Session") and "limits" in params
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = R.load_module(os.path.join(R.BENCH_DIR, "metrics",
                                         m["name"] + ".py"), "m")
        assert callable(mod.read)
