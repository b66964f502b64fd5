"""Readings for the limits of the comparisons that decide ``correct``.

    python -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...] \
        [--seconds 5] [--detail] [--runs control half look branch_bwd]

On the card, at the cell's own size, one process for every seed: the
cell's set-up with its check steps (for the eval cell a short window at the
cell's load), then the numbers compared for the program, and, as
``--runs`` asks, for the control (the reference put in the program's place
one precision step below the configuration's stated one: float8 for its
bfloat16), for planted faults (training: ``half``, half of the labelled
voxels left out of the loss; ``branch_bwd``, the reference with the
backward of every segment reduction of its image branches zeroed, as a
segment kernel's backward that returned zeros would leave it; eval: every
50th voxel's logits reversed where they are produced) and ``look``: the
reference at the stated precision against the reference in float32, leaf
by leaf, which shows what rounding at the stated precision alone does to
each number.  A step that leaves the state unchanged reads 1 on
``update_gap`` by construction and is not run.  Prints one JSON line per
seed.
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


def _own(session):
    """``loss_own_gap`` alone, which needs no reference run: the program's
    and the half-batch fault's (the loss of the program's own first logits
    over the first half of the samples)."""
    from benchmark.harness import checks as C

    rec, dev = session.record, session.device
    run = C.program_run(rec, session.init, {"weight_decay": 0.0}, dev)
    labels = C.first_labels(rec, dev)
    sample = torch.as_tensor(rec.coords[0][:, 0], device=dev)
    half = C.own_loss(run["logits"], labels,
                      sample < (int(sample.max()) + 1) // 2)
    full = run["own_loss"]
    return {"program": {"loss_own_gap": abs(run["loss"][0] - full) / full},
            "half_batch": {"loss_own_gap": abs(half - full) / full}}


def _train(session, detail, runs):
    from benchmark.harness import checks as C
    from benchmark.harness import recipe
    from benchmark.reference import model as M

    rec, init, cfg = session.record, session.init, session.cfg
    names, dev = set(session.names), session.device
    hp, groups = recipe.hyper(cfg), cfg["model"]["num_groups"]
    prec = C.stated_precision(cfg)

    def ref_run(p, **kw):
        return C.reference_run(rec, init, names, hp, groups, dev, p, **kw)

    ref = ref_run(prec)
    out = {"program": C.compare(C.program_run(rec, init, hp, dev), ref,
                                detail)}
    if "control" in runs:
        out["control"] = C.compare(ref_run(prec.lower()), ref, detail)
    if "half" in runs:
        out["half_batch"] = C.compare(ref_run(prec, half=True), ref, detail)
    if "look" in runs:
        out["look"] = C.compare(ref, ref_run(C.FLOAT32), detail)
    if "branch_bwd" in runs:
        seg_max, seg_sum = M._seg_max, M._seg_sum
        M._seg_max = lambda x, ids, n: seg_max(x, ids, n).detach()
        M._seg_sum = lambda x, ids, n: seg_sum(x, ids, n).detach()
        try:
            out["branch_bwd"] = C.compare(ref_run(prec), ref, detail)
        finally:
            M._seg_max, M._seg_sum = seg_max, seg_sum
    return out


def _eval(session):
    from benchmark.harness import checks as C

    samples = session.samples()
    args = (samples, session.init, set(session.names),
            session.cfg["model"]["num_groups"], session.device)
    prec = C.stated_precision(session.cfg)
    refs = C.eval_references(*args, prec)
    refs32 = C.eval_references(*args, C.FLOAT32)
    ctls = C.eval_references(*args, prec.lower())
    out = {"program": {}, "control": {}, "altered": {}}

    def worst(key, g):
        for k, v in g.items():
            out[key][k] = max(out[key].get(k, 0.0), v)

    for s, ref, ref32, ctl in zip(samples, refs, refs32, ctls):
        worst("control", C.logit_gaps(ctl, ref, ref32))
        for got in s["logits"]:
            got = torch.as_tensor(got, device=session.device)
            worst("program", C.logit_gaps(got, ref, ref32))
            bad = got.clone()
            bad[::50] = bad[::50].flip(-1)
            worst("altered", C.logit_gaps(bad, ref, ref32))
    out["program"]["vote_err"] = C.vote_error(session.votes,
                                              session.votes.log)
    out["program"]["batches_compared"] = len(samples)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--detail", action="store_true")
    parser.add_argument("--runs", nargs="*",
                        default=["control", "half", "look", "branch_bwd"],
                        help="training cells: which readings besides the "
                        "program's")
    parser.add_argument("--own", action="store_true",
                        help="training cells: loss_own_gap alone")
    args = parser.parse_args(argv)
    warnings.filterwarnings("ignore")
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
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
            if session.training:
                session.release()
                out = (_own(session) if args.own
                       else _train(session, args.detail, args.runs))
            else:
                session.window(args.seconds)
                session.release()
                out = _eval(session)
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
