"""Readings for the limits of a PTv2 training cell's ``correct``.

    python -m benchmark.calibrate_ptv2 --workload <cell> --seeds <n> \
        [<n> ...] [--detail] [--runs control look cross_sample no_peb_value
        no_mask no_pool_grad frozen half]

The PTv2 counterpart of :mod:`benchmark.calibrate_ptv3`, printing the same
JSON shape: on the card, at the cell's own size, one line per seed with the
numbers compared (:mod:`benchmark.harness.ptv2_checks`) for the program
against the reference at the stated precision, and, as ``--runs`` asks,
for the reference put in the program's place: ``control`` (one precision
step below the stated one: float8 e4m3 for bfloat16), ``cross_sample``
(neighbours searched across samples), ``no_peb_value`` (the positional
bias left out of the value path), ``no_mask`` (the mask not applied after
the softmax: it changes nothing where every sample of every level holds at
least ``k`` points), ``no_pool_grad`` (no gradient through the grid
pooling's maximum), ``frozen`` (the parameters left unchanged by the
optimizer's steps), ``half`` (the second half of each batch's samples left
out of the loss) and ``look`` (the reference at the stated precision
against the reference in float32: what rounding alone does).
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

RUNS = ("control", "look", "cross_sample", "no_peb_value", "no_mask",
        "no_pool_grad", "frozen", "half")
FAULTS = ("cross_sample", "no_peb_value", "no_mask", "no_pool_grad",
          "frozen")


def readings(session, runs, detail: bool = False):
    from benchmark.harness import ptv2_checks as C
    from benchmark.reference import ptv2 as ref

    rec, init, cfg, dev = (session.record, session.init, session.cfg,
                           session.device)
    prec = ref.Precision(cfg["precision"]["stated"])

    inputs = C.reference_inputs(rec, cfg, dev)

    def ref_run(p, faults=()):
        own = (C.reference_inputs(rec, cfg, dev, faults)
               if "cross_sample" in faults else inputs)
        return C.reference_run(rec, init, cfg, dev, p, faults, own)

    base = ref_run(prec)
    out = {"program": C.compare(C.program_run(rec, init, dev), base,
                                detail)}
    if "control" in runs:
        out["control"] = C.compare(ref_run(prec.lower()), base, detail)
    for fault in FAULTS:
        if fault in runs:
            out[fault] = C.compare(ref_run(prec, faults=(fault,)), base,
                                   detail)
    if "half" in runs:
        out["half"] = C.compare(C.reference_run(rec, init, cfg, dev, prec,
                                                inputs=inputs, half=True),
                                base, detail)
    if "look" in runs:
        out["look"] = C.compare(base, ref_run(ref.Precision("f32")), detail)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m benchmark.calibrate_ptv2")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--detail", action="store_true")
    parser.add_argument("--runs", nargs="*", default=list(RUNS))
    args = parser.parse_args(argv)
    warnings.filterwarnings("ignore")
    if not torch.cuda.is_available():
        print("calibrate_ptv2: needs a CUDA card", file=sys.stderr)
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
