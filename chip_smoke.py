"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives ``deepviewagg_tpu_torch`` end to end on the card and fails (non-zero
exit) on any fault:

  0. card     name and power limit; TF32 off for matmuls and convolutions
  1. build    compile every hand-written kernel (one nvcc per source, in
              parallel) from the checkout's ``csrc/``
  2. kernels  replay every sorted-segment call of one flagship forward
              through the CUDA kernel and through its plain PyTorch version
              on the same inputs (max exact, sum within 1e-5 relative), plus
              a case with empty, masked and all-masked segments; time the
              kernel, the plain version, ``torch.segment_reduce`` and the
              byte bound
  3. serving  the flagship model (Res16UNet34 + ResNet18-PPM branch, random
              weights from a seed) answers three requests of the benchmark's
              shape (4 samples, density 260, 12 images of 256 x 128), each
              preprocessed on the card; the kernel launch counts are zeroed
              just before and read just after
  4. card vs CPU  one smaller request through the same weights on the card
              and on the CPU (plain versions): logits within 3e-2 relative,
              argmax agreement >= 99%
  2b. backward kernels  replay every sorted-segment backward of one
              flagship train step (cotangents, inputs and saved results
              recorded from a real backward pass) through the CUDA backward
              kernel and its plain version: bit-equal for sum and max; plus
              empty, masked and all-masked segments with forced ties (every
              max-attaining row gets the full cotangent); time the kernel,
              the plain version, the library form (``index_select`` +
              ``where`` on precomputed ids) and the byte bound
  6. training the flagship model in training mode takes ten optimizer steps
              (SGD + momentum 0.9, LR 0.1, weight decay 1e-4, clip 10) on
              the benchmark request, two of them warm-up; the launch counts
              are zeroed just before and read just after; loss and gradient
              norm stay finite, the loss falls, every parameter and every
              running mean moves; then the trained model serves one request
              in eval mode
  7. card vs CPU, one train step  from identical weights on the smaller
              request: loss within 1e-2 relative, gradient norm within 3e-2
  5. trace    only with ``--trace``: device time by kernel family and the
              device's idle share over three forwards and three train steps
              (``torch.profiler``)

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line ``{"kernels": [...]}`` before it holds each kernel's launches, error
and times.  Needs a CUDA card, ``nvcc`` and the repository checkout.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from deepviewagg_tpu_torch.data.collate import batch_to_torch  # noqa: E402
from deepviewagg_tpu_torch.data.toy import flagship_spec, toy_batch  # noqa: E402
from deepviewagg_tpu_torch.models.losses import segmentation_loss  # noqa: E402
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg  # noqa: E402
from deepviewagg_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: E402
from deepviewagg_tpu_torch.ops import segment as seg  # noqa: E402
from deepviewagg_tpu_torch.train.optimizers import (  # noqa: E402
    make_optimizer, make_schedule)
from deepviewagg_tpu_torch.train.step import (  # noqa: E402
    TrainState, make_train_step)
from deepviewagg_tpu_torch.utils import cuda_build  # noqa: E402

# the benchmark request (bench.py's forward batch) and the graft-entry one
SERVE_REQUEST = dict(n_samples=4, density=260.0, image_size=(256, 128),
                     n_cameras=3)
CHECK_REQUEST = dict(n_samples=2, density=120.0, image_size=(128, 64),
                     n_cameras=2)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
SUM_RTOL = 1e-5                    # kernel vs plain: only summation order
LOGITS_RTOL = 3e-2                 # card vs CPU: bf16 tower convs differ
ARGMAX_AGREE = 0.99
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# card vs CPU train step: bf16 tower convs and the order of the pixel
# gather's scatter-add differ
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 3e-2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def valid_voxels(batch) -> int:
    return int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())


def make_request(seed: int, device: str, **shape):
    """A collated numpy request (preprocessed on ``device``) and its ms."""
    t0 = time.perf_counter()
    batch, _, _ = toy_batch(seed=seed, device=device, **shape)
    if device == "cuda":
        torch.cuda.synchronize()
    return batch, (time.perf_counter() - t0) * 1e3


def phase_card() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("0 card", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, allow_tf32_matmul=False,
        allow_tf32_cudnn=False)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.build()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    log("1 build", kernels=",".join(cuda_build.KERNELS),
        seconds=f"{time.perf_counter() - t0:.2f}")


def record_segment_calls(model, batch) -> list:
    """Every ``segment_csr`` call (cloned inputs) of one forward."""
    calls, inner = [], seg.segment_csr

    def recorder(x, ptr, valid, reduce):
        calls.append((x.clone(), ptr.clone(),
                      None if valid is None else valid.clone(), reduce))
        return inner(x, ptr, valid, reduce)

    seg.segment_csr = recorder
    try:
        with torch.no_grad():
            model(batch)
    finally:
        seg.segment_csr = inner
    torch.cuda.synchronize()
    return calls


def check_call(x, ptr, valid, reduce) -> dict:
    """Kernel vs plain on one input; raises when they disagree."""
    got = seg.segment_csr(x, ptr, valid, reduce)
    torch.cuda.synchronize()
    ref = seg.segment_csr_plain(x, ptr, valid, reduce)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if reduce == "max":
        if not torch.equal(got, ref):
            raise AssertionError(f"segment_csr max differs: {err}")
    elif got.numel() and rel_err(got, ref) > SUM_RTOL:
        raise AssertionError(f"segment_csr sum differs: {rel_err(got, ref)}")
    return {"max_abs_err": err}


def edge_case() -> None:
    """Empty, masked and all-masked segments, narrow and odd widths."""
    g = torch.Generator(device="cuda").manual_seed(0)
    e, s = 5000, 900
    ids = torch.sort(torch.randint(0, s // 2, (e,), generator=g,
                                   device="cuda"))[0]
    valid = (torch.rand(e, generator=g, device="cuda") > 0.3) & (ids % 5 != 1)
    ptr = seg.segment_ptr(ids.to(torch.int32), s)
    for c in (1, 3, 4, 64):
        x = torch.randn(e, c, generator=g, device="cuda")
        for reduce in ("sum", "max"):
            for v in (None, valid):
                check_call(x, ptr, v, reduce)
                out = seg.segment_csr(x, ptr, v, reduce)
                counts = ptr[1:] - ptr[:-1]
                if v is not None:
                    counts = seg.segment_csr_plain(
                        v[:, None].float(), ptr, None, "sum")[:, 0]
                if out[counts == 0].abs().sum() != 0:
                    raise AssertionError("empty or all-masked segment not 0")
    log("2 kernels", case="empty+masked+all-masked", widths="1,3,4,64",
        ok=True)


def phase_kernels(model, batch) -> dict:
    calls = record_segment_calls(model, batch)
    edge_case()
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  max_abs_err=0.0)
    for i, (x, ptr, valid, reduce) in enumerate(calls):
        res = check_call(x, ptr, valid, reduce)
        e, c = x.shape
        s = ptr.numel() - 1
        nbytes = (e * c * 4 + (e if valid is not None else 0)
                  + 4 * (s + 1) + s * c * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kms = time_ms(lambda: seg.segment_csr(x, ptr, valid, reduce))
        pms = time_ms(lambda: seg.segment_csr_plain(x, ptr, valid, reduce))
        # the library call on pre-masked rows (timing only; never used)
        fill = 0.0 if reduce == "sum" else float("-inf")
        xm = x if valid is None else torch.where(valid[:, None], x, fill)
        lms = time_ms(lambda: torch.segment_reduce(
            xm, reduce, offsets=ptr, axis=0, unsafe=True))
        log("2 kernels", call=i, reduce=reduce, rows=e, channels=c,
            segments=s, masked=valid is not None,
            kernel_ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lms:.4f}", bound_ms=f"{bound:.4f}",
            max_abs_err=res["max_abs_err"])
        totals["ms"] += kms
        totals["plain_ms"] += pms
        totals["library_ms"] += lms
        totals["bound_ms"] += bound
        totals["max_abs_err"] = max(totals["max_abs_err"], res["max_abs_err"])
    log("2 kernels", kernel="segment_csr", checked=True,
        calls_per_forward=len(calls))
    return totals


def zero_launches() -> None:
    for name in seg.LAUNCHES:
        seg.LAUNCHES[name] = 0


def serve_one(model, np_batch, phase: str, **fields) -> None:
    """One eval forward of a request on the card, checked: logits of the
    expected shape, finite on the valid voxels, through the forward kernel."""
    batch = batch_to_torch(np_batch, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = seg.LAUNCHES["segment_csr"]
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(batch)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    n = valid_voxels(np_batch)
    logits = out["logits"][:n]
    if logits.shape != (n, model.spec.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits on valid voxels")
    launched = seg.LAUNCHES["segment_csr"] - before
    if launched <= 0:
        raise AssertionError("the forward kernel was not launched")
    log(phase, **fields, voxels=n,
        images=int(np.asarray(np_batch["images"]).shape[0]),
        forward_ms=f"{fwd_ms:.1f}", voxels_per_s=f"{n / fwd_ms * 1e3:.0f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches={"segment_csr": launched})


def phase_serving(model, requests) -> dict:
    zero_launches()
    for i, (np_batch, prep_ms) in enumerate(requests):
        serve_one(model, np_batch, "3 serving", request=i,
                  preprocess_ms=f"{prep_ms:.1f}")
    if seg.LAUNCHES["segment_csr_bwd"] != 0:
        raise AssertionError("serving launched the backward kernel")
    return dict(seg.LAUNCHES)


def record_backward_calls(model, batch) -> list:
    """Every ``segment_csr_bwd`` call of one training-mode forward and
    backward: ``(g, x, out, ptr, valid, reduce, num_rows)`` as the autograd
    function hands them over (the cotangent cloned)."""
    calls, inner = [], seg.segment_csr_bwd

    def recorder(g, x, out, ptr, valid, reduce, num_rows=None):
        calls.append((g.clone(), x, out, ptr, valid, reduce, num_rows))
        return inner(g, x, out, ptr, valid, reduce, num_rows)

    seg.segment_csr_bwd = recorder
    try:
        out = model(batch)
        loss = segmentation_loss(out["logits"], batch["labels"],
                                 batch["graph"]["levels"][0]["valid"])
        loss.backward()
    finally:
        seg.segment_csr_bwd = inner
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return calls


def check_bwd_call(g, x, out, ptr, valid, reduce, num_rows) -> float:
    """Backward kernel vs plain on one input: bit-equal or it raises;
    returns the largest absolute difference (0.0 when they are equal)."""
    got = seg.segment_csr_bwd(g, x, out, ptr, valid, reduce, num_rows)
    torch.cuda.synchronize()
    ref = seg.segment_csr_bwd_plain(g, x, out, ptr, valid, reduce, num_rows)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if got.shape != ref.shape or not torch.equal(got, ref):
        raise AssertionError(f"segment_csr_bwd {reduce} differs: {err}")
    return err


def bwd_edge_case() -> None:
    """Empty, masked and all-masked segments, narrow and odd widths, with
    forced ties: both tied rows get the full cotangent, rows of an
    all-masked segment get none."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    e, s = 5000, 900
    ids = torch.sort(torch.randint(0, s // 2, (e,), generator=gen,
                                   device="cuda"))[0]
    valid = (torch.rand(e, generator=gen, device="cuda") > 0.3) & (ids % 5 != 1)
    ptr = seg.segment_ptr(ids.to(torch.int32), s)
    for c in (1, 3, 4, 64):
        x = torch.randn(e, c, generator=gen, device="cuda")
        # tie: copy each row onto its successor where both share a segment
        same = torch.zeros(e, dtype=torch.bool, device="cuda")
        same[1::2] = ids[1::2] == ids[0:-1:2]
        x[same] = x[torch.nonzero(same)[:, 0] - 1]
        g = torch.randn(s, c, generator=gen, device="cuda")
        for v in (None, valid):
            for reduce in ("sum", "max"):
                out = seg.segment_csr(x, ptr, v, reduce)
                check_bwd_call(g, x, out, ptr, v, reduce, e)
            out = seg.segment_csr(x, ptr, v, "max")
            gx = seg.segment_csr_bwd(g, x, out, ptr, v, "max")
            keep = torch.ones_like(valid) if v is None else v
            hit = keep[:, None] & (x == out[ids])
            if not torch.equal(gx[hit], g[ids][hit]):
                raise AssertionError("a max-attaining row lacks the full "
                                     "cotangent")
            tied = same & keep & torch.roll(keep, 1)
            both = tied[:, None] & hit
            if not (both.any() and torch.equal(
                    gx[both], torch.roll(gx, 1, 0)[both])):
                raise AssertionError("tied rows did not both get the cotangent")
            if v is not None:
                dead = ~valid | (ids % 5 == 1)
                if gx[dead].abs().sum() != 0:
                    raise AssertionError("masked or all-masked rows got "
                                         "gradient")
    log("2b backward kernels", case="empty+masked+all-masked+ties",
        widths="1,3,4,64", ok=True)


def phase_backward_kernels(model, batch) -> dict:
    calls = record_backward_calls(model, batch)
    if not calls:
        raise AssertionError("the train step recorded no segment backward")
    bwd_edge_case()
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  max_abs_err=0.0)
    for i, (g, x, out, ptr, valid, reduce, num_rows) in enumerate(calls):
        err = check_bwd_call(g, x, out, ptr, valid, reduce, num_rows)
        s, c = g.shape
        e = x.shape[0] if x is not None else num_rows
        # read g, valid, ptr (and x, out for max) once; write gx once
        nbytes = (s * c * 4 + (e if valid is not None else 0) + 4 * (s + 1)
                  + e * c * 4)
        if reduce == "max":
            nbytes += e * c * 4 + s * c * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kms = time_ms(lambda: seg.segment_csr_bwd(
            g, x, out, ptr, valid, reduce, num_rows))
        pms = time_ms(lambda: seg.segment_csr_bwd_plain(
            g, x, out, ptr, valid, reduce, num_rows))
        # the library form on precomputed ids (timing only; never used)
        ids, keep = seg._row_segments(ptr, e)
        if valid is not None:
            keep = keep & valid
        keep = keep[:, None]
        if reduce == "sum":
            lms = time_ms(lambda: torch.where(
                keep, g.index_select(0, ids), 0.0))
        else:
            lms = time_ms(lambda: torch.where(
                keep & (x == out.index_select(0, ids)) & (x > -5e29),
                g.index_select(0, ids), 0.0))
        log("2b backward kernels", call=i, reduce=reduce, rows=e, channels=c,
            segments=s, masked=valid is not None,
            kernel_ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lms:.4f}", bound_ms=f"{bound:.4f}",
            max_abs_err=err)
        totals["ms"] += kms
        totals["plain_ms"] += pms
        totals["library_ms"] += lms
        totals["bound_ms"] += bound
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    log("2b backward kernels", kernel="segment_csr_bwd", checked=True,
        bit_equal=True, calls_per_step=len(calls))
    return totals


def phase_training(model, np_batch, check_batch) -> dict:
    """Ten optimizer steps on one request; returns the launch counts."""
    model.train()
    batch = batch_to_torch(np_batch, device="cuda")
    n = valid_voxels(np_batch)
    state = TrainState.create(model, make_optimizer(
        make_schedule("constant", 0.1), grad_clip=10.0))
    step = make_train_step(model)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    means = {k: m.running_mean.clone() for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)}
    losses, step_ms = [], []
    torch.cuda.synchronize()
    zero_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        before = dict(seg.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, None)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {gnorm}")
        per_step = {k: seg.LAUNCHES[k] - before[k] for k in seg.LAUNCHES}
        if min(per_step.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {per_step}")
        losses.append(loss)
        if i >= TRAIN_WARMUP:
            step_ms.append(ms)
        log("6 training", step=i, loss=f"{loss:.4f}",
            grad_norm=f"{gnorm:.4f}", step_ms=f"{ms:.1f}",
            voxels_per_s=f"{n / ms * 1e3:.0f}", timed=i >= TRAIN_WARMUP,
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            launches=per_step)
    launches = dict(seg.LAUNCHES)
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"step counter {state.step}")
    no_grad = [k for k, p in model.named_parameters() if p.grad is None]
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), start[k])]
    if no_grad or still:
        raise AssertionError(f"parameters without gradient {no_grad[:5]} or "
                             f"unmoved {still[:5]}")
    stuck = [k for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)
             and torch.equal(m.running_mean, means[k])]
    if stuck:
        raise AssertionError(f"running means did not move: {stuck[:5]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    mean_ms = float(np.mean(step_ms))
    log("6 training", steps=TRAIN_STEPS, timed_steps=len(step_ms),
        params=sum(p.numel() for p in model.parameters()), voxels=n,
        first_loss=f"{losses[0]:.4f}", last_loss=f"{losses[-1]:.4f}",
        mean_step_ms=f"{mean_ms:.1f}", min_step_ms=f"{min(step_ms):.1f}",
        voxels_per_s=f"{n / mean_ms * 1e3:.0f}", launches=launches)
    model.eval()
    serve_one(model, check_batch, "6 training", after="training, eval mode")
    return launches


def phase_train_card_vs_cpu(model) -> None:
    """One train step from identical weights on the card and on the CPU."""
    np_batch, _ = make_request(0, "cuda", **CHECK_REQUEST)
    got = {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device)
        state = TrainState.create(m, make_optimizer(
            make_schedule("constant", 0.1), grad_clip=10.0))
        _, metrics = make_train_step(m)(
            state, batch_to_torch(np_batch, device), None)
        got[device] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        del m, state
    (loss, gnorm), (ref_loss, ref_gnorm) = got["cuda"], got["cpu"]
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    gnorm_err = abs(gnorm - ref_gnorm) / abs(ref_gnorm)
    log("7 train card vs cpu", voxels=valid_voxels(np_batch),
        loss=f"{loss:.6f}", cpu_loss=f"{ref_loss:.6f}",
        loss_rel_err=f"{loss_err:.3e}", grad_norm=f"{gnorm:.5f}",
        cpu_grad_norm=f"{ref_gnorm:.5f}", grad_norm_rel_err=f"{gnorm_err:.3e}")
    if not (loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GRAD_NORM_RTOL):
        raise AssertionError(
            f"card and CPU train steps disagree: {loss_err}, {gnorm_err}")


def phase_card_vs_cpu(model) -> None:
    np_batch, _ = make_request(0, "cuda", **CHECK_REQUEST)
    n = valid_voxels(np_batch)
    with torch.no_grad():
        card = model(batch_to_torch(np_batch, "cuda"))["logits"][:n].cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = cpu_model(batch_to_torch(np_batch, "cpu"))["logits"][:n]
    err = rel_err(card, cpu)
    agree = float((card.argmax(1) == cpu.argmax(1)).double().mean())
    log("4 card vs cpu", voxels=n, rel_err=f"{err:.3e}",
        argmax_agree=f"{agree:.5f}")
    if not (err <= LOGITS_RTOL and agree >= ARGMAX_AGREE):
        raise AssertionError(f"card and CPU disagree: {err}, {agree}")


def kernel_family(name: str) -> str:
    """Coarse family of a CUDA kernel name, for the trace summary."""
    low = name.lower()
    # cuDNN convs and cuBLAS GEMMs share "xmma"/"gemm" in their names; the
    # convs carry "conv", "fprop" or "implicit"
    for key, fam in (("segment_csr_bwd", "segment_csr_bwd (ours)"),
                     ("segment_csr", "segment_csr (ours)"),
                     ("conv", "conv2d"), ("fprop", "conv2d"),
                     ("implicit", "conv2d"), ("gemm", "matmul"),
                     ("index", "gather/scatter"), ("gather", "gather/scatter"),
                     ("scatter", "gather/scatter"), ("sort", "sort/search"),
                     ("search", "sort/search"), ("reduce", "reduction"),
                     ("norm", "norm"), ("copy", "copy/cast"),
                     ("cat", "copy/cast"), ("elementwise", "elementwise")):
        if key in low:
            return fam
    return "other"


def phase_trace(what: str, run, repeats: int = 3) -> None:
    """Device time by kernel family and the device's idle share over
    ``repeats`` calls of ``run`` (one forward or one train step of one
    request) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fams: dict = {}
    for ev in prof.key_averages():
        # device-side events only: an operator's entry repeats its kernels'
        us = ev.self_device_time_total
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + us
    busy = sum(fams.values())
    log("5 trace", what=what, repeats=repeats,
        wall_ms_each=f"{wall_us / repeats / 1e3:.2f}",
        device_ms_each=f"{busy / repeats / 1e3:.2f}",
        idle_share=f"{1 - busy / wall_us:.3f}")
    for fam, us in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("5 trace", what=what, family=fam,
            ms_each=f"{us / repeats / 1e3:.3f}", share=f"{us / busy:.3f}")


def trace_forward_and_train(model, train_model, np_batch) -> None:
    batch = batch_to_torch(np_batch, device="cuda")

    def forward():
        with torch.no_grad():
            model(batch)

    phase_trace("forward", forward)
    train_model.train()
    state = TrainState.create(train_model, make_optimizer(
        make_schedule("constant", 0.1), grad_clip=10.0))
    step = make_train_step(train_model)
    step(state, batch, None)                       # warm-up, not traced
    phase_trace("train_step", lambda: step(state, batch, None))


def main() -> None:
    trace = "--trace" in sys.argv[1:]
    device = phase_card()
    phase_build()
    t0 = time.perf_counter()
    model = MultimodalSeg(flagship_spec(), device="cuda", seed=0).eval()
    log("3 serving", model="flagship", params=sum(
        p.numel() for p in model.parameters()),
        build_s=f"{time.perf_counter() - t0:.1f}")
    requests = [make_request(seed, "cuda", **SERVE_REQUEST)
                for seed in range(3)]
    totals = phase_kernels(model, batch_to_torch(requests[0][0], "cuda"))
    launches = phase_serving(model, requests)
    phase_card_vs_cpu(model)
    # training runs on a copy, so the serving model keeps its weights
    train_model = copy.deepcopy(model).train()
    bwd_totals = phase_backward_kernels(
        train_model, batch_to_torch(requests[0][0], "cuda"))
    train_launches = phase_training(train_model, requests[0][0],
                                    requests[1][0])
    phase_train_card_vs_cpu(model)
    if trace:
        trace_forward_and_train(model, train_model, requests[0][0])

    def entry(name, source, replaces, totals, **counts):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, **counts,
            "max_abs_err": totals["max_abs_err"],
            "ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": "bytes",
            "library_ms": totals["library_ms"], "checked": True,
        }

    # ``launches``: the kernel's count over the path that drives it first
    # (serving for the forward, training for the backward); times are sums
    # over the calls of one forward / one train step
    kernels = [
        entry("segment_csr", "deepviewagg_tpu_torch/csrc/segment_csr.cu",
              "deepviewagg_tpu/ops/pallas_segment.py:75", totals,
              launches=launches["segment_csr"],
              launches_training=train_launches["segment_csr"]),
        entry("segment_csr_bwd",
              "deepviewagg_tpu_torch/csrc/segment_csr_bwd.cu",
              "deepviewagg_tpu/ops/pallas_segment.py:177", bwd_totals,
              launches=train_launches["segment_csr_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
