"""Readings for the limits of a PTv3 training cell's ``correct``.

    python -m benchmark.calibrate_ptv3 --workload <cell> --seeds <n> \
        [<n> ...] [--detail] [--runs control half look order0 short_patch]

The PTv3 counterpart of :mod:`benchmark.calibrate` (whose training path
reads the multimodal reference), printing the same JSON shape: on the card,
at the cell's own size, one line per seed with the numbers compared
(:mod:`benchmark.harness.ptv3_checks`) for the program against the
reference at the stated precision, and, as ``--runs`` asks, for the
reference put in the program's place: ``control`` (one precision step
below the stated one: float8 e4m3 for bfloat16), ``half`` (half of each
batch's samples left out of the loss), ``order0`` (every block attends in
the first order), ``short_patch`` (the last patch of each sample left short
instead of filled) and ``look`` (the reference at the stated precision
against the reference in float32: what rounding alone does).  A step that
leaves the state unchanged reads 1 on ``update_gap_part`` by construction
and is not run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import warnings

import torch

RUNS = ("control", "half", "look", "order0", "short_patch")


def readings(session, runs, detail: bool = False):
    from benchmark.harness import ptv3_checks as C
    from benchmark.reference import ptv3 as ref

    rec, init, cfg, dev = (session.record, session.init, session.cfg,
                           session.device)
    prec = ref.Precision(cfg["precision"]["stated"])
    steps = session.total_steps

    def ref_run(p, **kw):
        return C.reference_run(rec, init, cfg, steps, dev, p, **kw)

    base = ref_run(prec)
    out = {"program": C.compare(C.program_run(rec, init, dev), base,
                                detail)}
    plan = {"control": dict(p=prec.lower()),
            "half_batch": dict(p=prec, half=True),
            "order0": dict(p=prec, faults=("order0",)),
            "short_patch": dict(p=prec, faults=("short_patch",))}
    for name, kw in plan.items():
        if (name if name != "half_batch" else "half") in runs:
            p = kw.pop("p")
            out[name] = C.compare(ref_run(p, **kw), base, detail)
    if "look" in runs:
        out["look"] = C.compare(base, ref_run(ref.Precision("f32")), detail)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m benchmark.calibrate_ptv3")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--detail", action="store_true")
    parser.add_argument("--runs", nargs="*", default=list(RUNS))
    args = parser.parse_args(argv)
    warnings.filterwarnings("ignore")
    if not torch.cuda.is_available():
        print("calibrate_ptv3: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import run as R
    from benchmark.harness.trace import Spans

    bench = R.load_bench()
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell, cfg, params, traffic = R.load_cell(bench, args.workload)
        workdir = os.path.join(os.environ.get("TMPDIR", "/tmp"), "dva_cal",
                               f"{args.workload}-{seed}")
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        session = traffic.Session(cfg, params, seed, "cuda", Spans(False),
                                  workdir)
        try:
            session.setup()
            session.release()
            out = readings(session, args.runs, args.detail)
        finally:
            session.close()
            shutil.rmtree(workdir, ignore_errors=True)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        del session
    return 0


if __name__ == "__main__":
    sys.exit(main())
