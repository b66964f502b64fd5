"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
entry there names its configuration (``benchmark/configs/<config>.json``)
and its traffic; ``benchmark/workloads/<cell>.json`` holds the traffic's
parameters and the limits of the comparisons that decide ``correct``; the
traffic's generator is ``benchmark/traffic/<kind>.py`` (``kind``: the
traffic's name up to its first dot); each metric is read by
``benchmark/metrics/<metric>.py``.  The run sets up (data, model, weights
from ``--seed``, the first training steps or nothing), measures for
``--seconds``, checks what the window computed against the plain reference
(``benchmark/reference/``) and prints one JSON line last.  With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

Exits 3 without a result where no card (or fewer than the cell asks for) is
visible, 4 where a module of JAX or of the JAX package has been loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
# compared by the whole top-level name: the port's name begins with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepviewagg_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _reported(entry, cell, e2e_names):
    if "workloads" in entry:
        return cell["name"] in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def cell_metrics(bench, cell, traced):
    """The metric entries a run of ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if _reported(m, cell, names)]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(bench, name, bench_dir=BENCH_DIR):
    """(cell entry, configuration, workload parameters, traffic module)."""
    cell = find_cell(bench, name)
    cfg = load_json(bench_dir, "configs", cell["config"] + ".json")
    params = load_json(bench_dir, "workloads", name + ".json")
    kind = cell["traffic"].split(".")[0]
    traffic = importlib.import_module(f"benchmark.traffic.{kind}")
    return cell, cfg, params, traffic


def card_info(chips):
    """The card's name and power limit; raises where too few cards are
    visible."""
    import subprocess

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"needs {chips} CUDA device(s), {n} visible")
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": limit}


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self, cell, cfg, params, traced):
        self.cell, self.cfg, self.params = cell, cfg, params
        self.traced = traced
        self.setup_s = None
        self.window_s = None
        self.counters = {}
        self.spans = None
        self.peak_bytes = None
        self.trace = None
        self.extra = {}
        self.device = {}


def execute(cell_name, seed, seconds, traced, device="cuda", bench=None,
            bench_dir=BENCH_DIR, t0=None, workdir=None):
    """Set up, measure, check; returns ``(run, checks, session)``."""
    import torch

    from benchmark.harness.trace import (DeviceTrace, ModelProbe, Spans,
                                         window_segment_bytes)

    bench = bench or load_bench()
    cell, cfg, params, traffic = load_cell(bench, cell_name, bench_dir)
    run = Run(cell, cfg, params, traced)
    spans = Spans(traced)
    run.spans = spans
    workdir = workdir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "dva_bench", f"{cell_name}-{seed}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    session = traffic.Session(cfg, params, seed, device, spans, workdir)
    try:
        session.setup()
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - (t0 if t0 is not None else _T0)
        probe = tracer = None
        if traced:
            probe = ModelProbe(session.model, spans, session.optimizer,
                               backward=session.training)
            tracer = DeviceTrace(spans, workdir)
            session.trace_mode()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if tracer is not None:
            with tracer:
                run.counters, run.window_s = session.window(seconds)
        else:
            run.counters, run.window_s = session.window(seconds)
        if cuda:
            torch.cuda.synchronize()
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if traced:
            probe.remove()
            run.extra["device_ms"] = probe.device_ms()
            run.trace = tracer.summary()
            run.extra["segment_bytes"] = (0.0, 0.0)
            if session.training:
                from deepviewagg_tpu_torch.ops import segment as seg

                run.extra["segment_bytes"] = window_segment_bytes(
                    seg, [b for b, _ in session.window_batches],
                    session.replay_step)
            run.extra["flops"] = session.window_flops()
        session.release()
        checks = session.check()
    finally:
        session.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return run, checks, session


def read_metrics(run, entries, bench_dir=BENCH_DIR):
    out = {}
    for m in entries:
        reader = load_module(os.path.join(bench_dir, "metrics",
                                          m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(checks, limits):
    """``(correct, {name: {"value", "limit"}})``: every compared number at
    or under its limit."""
    table = {}
    ok = True
    for name, limit in limits.items():
        value = checks.get(name)
        table[name] = {"value": value, "limit": limit}
        if value is None or not (value <= limit):
            ok = False
    return ok, table


def result_line(run, checks, bench, device, bench_dir=BENCH_DIR):
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when traced),
    ``breakdown`` when traced, and last ``checks``: each number compared
    with its limit."""
    correct, table = verdict(checks, run.params["limits"])
    run.device = device = dict(device)
    device["memory_peak_bytes"] = run.peak_bytes
    if run.traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    result = {
        "correct": correct,
        "attempted": run.counters["attempted"],
        "failed": run.counters["failed"],
        "metrics": read_metrics(run, cell_metrics(bench, run.cell,
                                                  run.traced), bench_dir),
        "device": device,
    }
    if run.traced:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = table
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    warnings.filterwarnings("ignore")
    bench = load_bench()
    cell = find_cell(bench, args.workload)
    # the program's kernel caches stay in the checkout, at fixed paths
    cache = os.path.join(BENCH_DIR, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    try:
        device = card_info(cell["chips"])
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, checks, _ = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    result = result_line(run, checks, bench, device)
    parts = {k: round(sum(v), 3) for k, v in run.spans.times.items()
             if k.startswith("setup_")}
    print(f"setup parts (s): {parts} of {run.setup_s:.3f}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
