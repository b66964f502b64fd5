"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives ``deepviewagg_tpu_torch`` end to end on the card and fails (non-zero
exit) on any fault:

  0. card     name and power limit; TF32 off for matmuls and convolutions
  1. build    compile every hand-written kernel (one nvcc per source, in
              parallel) from the checkout's ``csrc/``
  2. kernels  replay every sorted-segment call of one flagship forward
              (six, no two of them the same reduction) through the CUDA
              kernel and through its plain PyTorch version on the same inputs
              (max exact, sum within 1e-5 relative, the same bits on two
              runs), plus empty, masked and all-masked segments and the
              tile-edge cases of ``segment_edge_cases``; time the kernel
              alone on the device (``kernel_ms``: launches into preallocated
              tensors, captured in a CUDA graph of N and of 2N launches, so
              the host is not the limit), the call through the wrapper
              (``call_ms``), the plain version, ``torch.segment_reduce`` and
              the byte bound (``x`` counted at its live rows only: a masked
              row need not be read); ``--tune`` also sweeps the kernel's
              tile size
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
              max-attaining row gets the full cotangent); time the kernel
              alone (``kernel_ms``, as in phase 2), the call through the
              wrapper (``call_ms``), the plain version, the library form
              (``index_select`` + ``where`` on precomputed ids) and the byte
              bound (``x`` at its live rows, ``g`` and the result at the
              segments that hold one)
  6. training the flagship model in training mode takes ten optimizer steps
              (SGD + momentum 0.9, LR 0.1, weight decay 1e-4, clip 10) on
              the benchmark request, two of them warm-up; the launch counts
              are zeroed just before and read just after; loss and gradient
              norm stay finite, the loss falls, every parameter and every
              running mean moves; then the trained model serves one request
              in eval mode, and a model with ``remat_tower=False`` takes six
              steps from the same weights (step ms and peak memory without
              the default ``'convs'`` remat, same first loss)
  7. card vs CPU, one train step  from identical weights on the smaller
              request: loss within 1e-2 relative, gradient norm within 3e-2
  8. recipe request  the crop-ladder batch at the S3DIS recipe's 2D size
              (``recipe_batch()``: 2 samples, 4 panoramas of 1024 x 512 in
              the ladder's largest bucket, about 934k pixel rows; three
              smaller buckets with one zero image and 256 masked rows each),
              through the same flagship weights, nothing cut:
              8a  every sorted-segment forward and backward call of one
                  recipe forward / train step (one atomic pool per bucket,
                  three of them with every row masked and every segment
                  empty, then the view pool's) held against its plain
                  version and timed as in phases 2 / 2b
              8b  the pixel gather at the largest bucket's shape, timed in
                  its parts: the upsample einsums, the row gather and its
                  backward as ``index_select`` (atomics, what the port uses)
                  and as ``flat[idx]`` (``index_put_`` with accumulate, a
                  sort), and the four-tap form
              8c  serving: four forwards in eval mode (one warm-up);
                  preprocess ms, forward ms, voxels/s, peak memory; launch
                  counts zeroed before and read after
              8d  training: eight optimizer steps with ``remat_tower='convs'``
                  (two warm-up), the loss must fall and every parameter and
                  running mean move; then five steps each with ``False`` and
                  ``True`` from the same weights: step ms, peak memory, and
                  the loss of the second step equal across the three modes
                  within 2e-3
              8e  card vs CPU on the check request as a ladder batch (ladder
                  (64, 32), (128, 64)): logits and one train step to the
                  bounds of phases 4 and 7
  9. loop     the experiment loop, through ``deepviewagg_tpu_torch.cli.
              train.main`` in this process (data and run dirs under a
              temporary directory, deleted afterwards); every train step
              closed by a synchronisation and checked (finite loss, 6 + 5
              segment launches), the consumer's wait on the train loader
              timed:
              9a  ``conf/synthetic.yaml`` (the Quick start: Res16UNet14-L1
                  group-4 branch, 128 x 64 images, batch 2) for two epochs
                  with an eval each: ``metrics.jsonl`` holds two records
                  with ``val_miou``, ``latest`` and ``best_val_miou`` exist,
                  every parameter is on the card and moved, both kernels
                  launched; then ``training.resume=true`` for one epoch:
                  the restored model and optimizer equal the saved ones bit
                  for bit before the first resumed step, and the step count
                  continues from the saved one
              9b  ``conf/s3dis_benchmark.yaml`` with ``data.dataset=
                  synthetic`` (``RECIPE_LOOP``): the recipe's model at its
                  published widths (deep-stem 512-d L4 tower, group-4 pool,
                  concat before the stem, trained from scratch), batch 4,
                  4 image slots of 1024 x 512, 2 m spheres at 5 cm, two
                  epochs of 48 spheres with an eval each; prints cache
                  build ms, bucket probe ms and capacities, step ms, loader
                  wait ms and valid voxels per batch, eval-epoch ms, peak
                  memory and launches per step; then every sorted-segment
                  forward and backward call of the first train batch
                  (the atomic pool and the view pool at 512 channels) held
                  against its plain version and timed as in phases 2 / 2b
  5. trace    only with ``--trace``: device time by kernel family and the
              device's idle share over three forwards and three train steps
              of the benchmark request and of the recipe request
              (``torch.profiler``)

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line ``{"kernels": [...]}`` before it holds each kernel's launches, error
and times (``ms``: device time of the kernel alone, summed over the calls of
one forward or one train step; ``call_ms``: the same calls through the
wrapper; ``recipe``: the same for the recipe request; ``loop_recipe``: the
same for phase 9b's first train batch; ``launches_loop_*``: the counts over
phase 9's runs).  Needs a CUDA card,
``nvcc`` and the repository checkout.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from deepviewagg_tpu_torch.data.collate import batch_to_torch  # noqa: E402
from deepviewagg_tpu_torch.data.toy import (  # noqa: E402
    flagship_spec, recipe_batch, toy_batch)
from deepviewagg_tpu_torch.models.losses import segmentation_loss  # noqa: E402
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg  # noqa: E402
from deepviewagg_tpu_torch.modules import gather as pixel_gather  # noqa: E402
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
NO_REMAT_STEPS = 4                 # timed steps with remat_tower=False
# sorted-segment launches of the flagship: atomic max, set-encoder max, one
# count, one compatibility max, softmax sum, weighted sum; the count has no
# gradient
FORWARD_LAUNCHES, BACKWARD_LAUNCHES = 6, 5
GRAPH_LAUNCHES = 20                # launches per captured graph (and twice)
EDGE_WIDTHS = (1, 3, 4, 5, 32, 64, 128, 130)
TUNE_TILES = (32, 64, 128, 256, 512, 1024, 2048)
# card vs CPU train step: bf16 tower convs and the order of the pixel
# gather's scatter-add differ
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 3e-2
# the recipe request: recipe_batch()'s defaults; the card vs CPU check takes
# the flat check's request as a ladder batch (ladder (64, 32), (128, 64)),
# so that the same bounds apply: at 64 x 32 images the tower's maps are 8 x 4
# cells and the bf16 gradient norm alone differs by 4.9e-2 between card and
# CPU (loss 7.5e-4, logits 2.3e-3)
RECIPE_IMAGE_SIZE = (1024, 512)
LADDER_CHECK_REQUEST = dict(min_size=32, **CHECK_REQUEST)
RECIPE_FORWARDS = 4                # one of them warm-up
RECIPE_STEPS, RECIPE_WARMUP = 8, 2
RECIPE_SHORT_STEPS = 5             # remat False and True, two of them warm-up
# per ladder batch: one atomic pool per bucket that holds an image, then the
# view pool's five reductions (four of them differentiated)
VIEW_POOL_FORWARD, VIEW_POOL_BACKWARD = 5, 4
REMAT_LOSS_RTOL = 2e-3             # second step's loss, across remat modes
# phase 9: the experiment loop through ``deepviewagg_tpu_torch.cli.train``;
# the S3DIS recipe (conf/s3dis_benchmark.yaml) on synthetic rooms, cut to
# two epochs of 48 spheres (12 batches) with an eval every epoch (the
# recipe: 200 x 2000, eval every 5); rooms of 6 x 4 x 2.6 m at 600 points
# per m^2, six 1024 x 512 panoramas each, so that a 2 m sphere at 5 cm holds
# about as many voxels as the cache's 6 cm grid gives
CONF = Path(__file__).resolve().parent / "conf"
QUICK_EPOCHS = 2
RECIPE_LOOP = ("data.dataset=synthetic", "data.samples_per_epoch=48",
               "training.epochs=2", "training.eval_frequency=1",
               "data.kwargs={n_areas: 2, density: 600.0, n_cameras: 6}")


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


def graph_ms(launch, n: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time of one ``launch()`` in ms: ``n`` launches captured in a
    CUDA graph, the graph replayed between two CUDA events, so that no host
    work lies between the kernels.  ``launch`` must not allocate."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n)


def kernel_ms(launch, tries: int = 3) -> tuple:
    """``(ms, ms at twice the launches)`` of one kernel launch on the device;
    raises when the two differ by more than half and 2 us (the host, not the
    device, would then be what is timed) in each of ``tries`` measurements:
    a single one can be off by a clock change on the card."""
    for _ in range(tries):
        once, twice = graph_ms(launch), graph_ms(launch, 2 * GRAPH_LAUNCHES)
        if abs(once - twice) <= max(0.5 * min(once, twice), 2e-3):
            return once, twice
    raise AssertionError(f"kernel time depends on the number of launches: "
                         f"{once} vs {twice} ms")


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
    if not torch.equal(got, seg.segment_csr(x, ptr, valid, reduce)):
        raise AssertionError("segment_csr: two runs gave different bits")
    ref = seg.segment_csr_plain(x, ptr, valid, reduce)
    if got.shape != ref.shape:
        raise AssertionError(f"segment_csr shape {tuple(got.shape)}")
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
    # the edges of the tiling, at each width's own tile size
    names = []
    for c in EDGE_WIDTHS:
        tile = seg.kernel_tile_rows(c)
        for name, x, ptr, v in seg.segment_edge_cases(tile, c):
            x, ptr = x.cuda(), ptr.cuda()
            v = None if v is None else v.cuda()
            for reduce in ("sum", "max"):
                try:
                    check_call(x, ptr, v, reduce)
                except AssertionError as exc:
                    raise AssertionError(
                        f"edge case {name}, width {c}, tile {tile}: {exc}")
            names.append(name)
    log("2 kernels", case="tile edges: " + "+".join(dict.fromkeys(names)),
        widths=",".join(map(str, EDGE_WIDTHS)), ok=True)


def live_rows(ptr, valid, num_rows: int) -> int:
    """Rows a segment reduction has to read: inside ``[ptr[0], ptr[-1])``
    and valid.  The byte bounds count ``x`` at these rows only."""
    lo, hi = int(ptr[0]), int(ptr[-1])
    if valid is None:
        return hi - lo
    return int(valid[lo:hi].sum())


def live_segments(ptr, valid, num_rows: int) -> int:
    """Segments that hold a live row: the only rows of ``g`` (and of the
    forward's result) that a backward has to read."""
    keep = (torch.ones(num_rows, device=ptr.device) if valid is None
            else valid.float())
    return int((seg.segment_csr_plain(keep[:, None], ptr, None, "sum")
                > 0).sum())


def forward_buffers(x, ptr, tile):
    """Preallocated ``(out, scratch)`` of one forward launch."""
    e, c = x.shape
    return (torch.empty((ptr.numel() - 1, c), device="cuda"),
            seg.segment_csr_scratch(e, c, tile, "cuda"))


def check_distinct(calls) -> None:
    """No two recorded calls are the same reduction of the same rows."""
    for i, a in enumerate(calls):
        for j in range(i):
            b = calls[j]
            same = a[3] == b[3] and all(
                (u is None) == (v is None) and (u is None or (
                    u.shape == v.shape and torch.equal(u, v)))
                for u, v in zip(a[:3], b[:3]))
            if same:
                raise AssertionError(f"calls {j} and {i} are one reduction")


def tune_tiles(calls) -> None:
    """Device time of every recorded call at every tile size, each first
    held against the plain version; then the two kernels' shares of a call
    at the default tile size, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for i, (x, ptr, valid, reduce) in enumerate(calls):
        e, c = x.shape
        ref = seg.segment_csr_plain(x, ptr, valid, reduce)
        times = {}
        for tile in TUNE_TILES:
            out, scratch = forward_buffers(x, ptr, tile)

            def launch():
                seg.segment_csr_into(x, ptr, valid, out, scratch, reduce,
                                     tile)

            launch()
            if reduce == "max" and not torch.equal(out, ref):
                raise AssertionError(f"tile {tile}: max")
            if reduce == "sum" and rel_err(out, ref) > SUM_RTOL:
                raise AssertionError(f"tile {tile}: sum")
            times[tile] = graph_ms(launch)
        log("2 kernels tune", call=i, reduce=reduce, rows=e, channels=c,
            default_tile=seg.kernel_tile_rows(c),
            **{f"tile{t}_ms": f"{ms:.4f}" for t, ms in times.items()})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, ptr, valid, reduce in calls:
            for _ in range(10):
                seg.segment_csr(x, ptr, valid, reduce)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "segment_csr" in ev.key:
            log("2 kernels tune", kernel=ev.key[:100].replace(" ", ""),
                launches=ev.count,
                mean_us=f"{ev.self_device_time_total / ev.count:.2f}")


def phase_kernels(model, batch, tune: bool = False) -> dict:
    calls = record_segment_calls(model, batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    check_distinct(calls)
    edge_case()
    if tune:
        tune_tiles(calls)
    return measure_forward_calls(calls, "2 kernels", "calls_per_forward")


def measure_forward_calls(calls, phase: str, count_key: str) -> dict:
    """Hold every recorded forward call against its plain version and time
    it: the kernel alone, the call through the wrapper, the plain version,
    the library call; returns the sums over the calls."""
    totals = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  bound_ms=0.0, max_abs_err=0.0)
    for i, (x, ptr, valid, reduce) in enumerate(calls):
        res = check_call(x, ptr, valid, reduce)
        e, c = x.shape
        s = ptr.numel() - 1
        # read the live rows of x, valid and ptr once; write out once
        live = live_rows(ptr, valid, e)
        nbytes = (live * c * 4 + (e if valid is not None else 0)
                  + 4 * (s + 1) + s * c * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        tile = seg.kernel_tile_rows(c)
        out, scratch = forward_buffers(x, ptr, tile)
        kms, kms2 = kernel_ms(lambda: seg.segment_csr_into(
            x, ptr, valid, out, scratch, reduce, tile))
        cms = time_ms(lambda: seg.segment_csr(x, ptr, valid, reduce))
        pms = time_ms(lambda: seg.segment_csr_plain(x, ptr, valid, reduce))
        # the library call on pre-masked rows (timing only; never used)
        fill = 0.0 if reduce == "sum" else float("-inf")
        xm = x if valid is None else torch.where(valid[:, None], x, fill)
        lms = time_ms(lambda: torch.segment_reduce(
            xm, reduce, offsets=ptr, axis=0, unsafe=True))
        log(phase, call=i, reduce=reduce, rows=e, channels=c,
            segments=s, masked=valid is not None,
            drop_rows=int(ptr[-1] - ptr[-2]), live_rows=live,
            empty_segments=int((ptr[1:] == ptr[:-1]).sum()), tile=tile,
            kernel_ms=f"{kms:.4f}", kernel_ms_2n=f"{kms2:.4f}",
            call_ms=f"{cms:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lms:.4f}", bound_ms=f"{bound:.4f}",
            max_abs_err=res["max_abs_err"])
        for key, ms in (("ms", kms), ("call_ms", cms), ("plain_ms", pms),
                        ("library_ms", lms), ("bound_ms", bound)):
            totals[key] += ms
        totals["max_abs_err"] = max(totals["max_abs_err"], res["max_abs_err"])
    log(phase, kernel="segment_csr", checked=True,
        **{count_key: len(calls)}, kernel_ms=f"{totals['ms']:.4f}",
        call_ms=f"{totals['call_ms']:.4f}",
        bound_ms=f"{totals['bound_ms']:.4f}")
    return totals


def zero_launches() -> None:
    for name in seg.LAUNCHES:
        seg.LAUNCHES[name] = 0


def image_count(np_batch) -> int:
    """Images a request carries (a ladder batch: over its buckets, padding
    images included)."""
    if "images" in np_batch:
        return int(np.asarray(np_batch["images"]).shape[0])
    return sum(int(im.shape[0]) for im in np_batch["bucket_images"])


def serve_one(model, np_batch, phase: str, expect: int = FORWARD_LAUNCHES,
              batch=None, **fields) -> float:
    """One eval forward of a request on the card, checked: logits of the
    expected shape, finite on the valid voxels, through ``expect`` launches
    of the forward kernel; returns the forward's ms."""
    if batch is None:
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
    if launched != expect:
        raise AssertionError(f"{launched} forward launches, expected "
                             f"{expect}")
    log(phase, **fields, voxels=n, images=image_count(np_batch),
        forward_ms=f"{fwd_ms:.1f}", voxels_per_s=f"{n / fwd_ms * 1e3:.0f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches={"segment_csr": launched})
    return fwd_ms


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
    # the forward's tile-edge inputs (all-empty and interleaved-empty calls
    # of a crop-ladder bucket among them), with a random cotangent
    names = []
    for c in (1, 4, 128):
        for name, x, ptr, v in seg.segment_edge_cases(
                seg.kernel_tile_rows(c), c):
            x, ptr = x.cuda(), ptr.cuda()
            v = None if v is None else v.cuda()
            g = torch.randn(ptr.numel() - 1, c, generator=gen, device="cuda")
            for reduce in ("sum", "max"):
                out = seg.segment_csr(x, ptr, v, reduce)
                try:
                    check_bwd_call(g, x, out, ptr, v, reduce, x.shape[0])
                except AssertionError as exc:
                    raise AssertionError(f"edge case {name}, width {c}: {exc}")
            names.append(name)
    log("2b backward kernels",
        case="tile edges: " + "+".join(dict.fromkeys(names)),
        widths="1,4,128", ok=True)


def phase_backward_kernels(model, batch) -> dict:
    calls = record_backward_calls(model, batch)
    if not calls:
        raise AssertionError("the train step recorded no segment backward")
    bwd_edge_case()
    if len(calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment backwards in one step")
    return measure_backward_calls(calls, "2b backward kernels")


def measure_backward_calls(calls, phase: str) -> dict:
    """Hold every recorded backward call against its plain version
    (bit-equal) and time it as :func:`measure_forward_calls` does."""
    totals = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  bound_ms=0.0, max_abs_err=0.0)
    for i, (g, x, out, ptr, valid, reduce, num_rows) in enumerate(calls):
        err = check_bwd_call(g, x, out, ptr, valid, reduce, num_rows)
        s, c = g.shape
        e = x.shape[0] if x is not None else num_rows
        # read valid, ptr, g at the segments that hold a live row (and, for
        # max, the result there and the live rows of x: a masked row's
        # gradient is 0 whatever x holds) once; write gx once
        live, live_s = live_rows(ptr, valid, e), live_segments(ptr, valid, e)
        nbytes = (live_s * c * 4 + (e if valid is not None else 0)
                  + 4 * (s + 1) + e * c * 4)
        if reduce == "max":
            nbytes += live * c * 4 + live_s * c * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        gx = torch.empty((e, c), device="cuda")
        kms, kms2 = kernel_ms(lambda: seg.segment_csr_bwd_into(
            g, x, out, ptr, valid, gx, reduce))
        cms = time_ms(lambda: seg.segment_csr_bwd(
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
        log(phase, call=i, reduce=reduce, rows=e, channels=c,
            segments=s, masked=valid is not None,
            drop_rows=int(ptr[-1] - ptr[-2]), live_rows=live,
            live_segments=live_s, kernel_ms=f"{kms:.4f}", kernel_ms_2n=f"{kms2:.4f}",
            call_ms=f"{cms:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lms:.4f}", bound_ms=f"{bound:.4f}",
            max_abs_err=err)
        for key, ms in (("ms", kms), ("call_ms", cms), ("plain_ms", pms),
                        ("library_ms", lms), ("bound_ms", bound)):
            totals[key] += ms
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    log(phase, kernel="segment_csr_bwd", checked=True,
        bit_equal=True, calls_per_step=len(calls),
        kernel_ms=f"{totals['ms']:.4f}", call_ms=f"{totals['call_ms']:.4f}",
        bound_ms=f"{totals['bound_ms']:.4f}")
    return totals


def run_steps(model, batch, n_voxels: int, steps: int, warmup: int,
              phase: str, expect: dict, **fields) -> dict:
    """``steps`` optimizer steps (SGD + momentum 0.9, LR 0.1, weight decay
    1e-4, clip 10) of ``model`` on one batch on the card, each closed by a
    synchronisation and checked (finite loss and gradient norm, ``expect``
    launches); returns losses, timed step ms, the largest peak memory and
    what was resident before the first step (models, batches: the peaks of
    two runs compare only over it)."""
    model.train()
    state = TrainState.create(model, make_optimizer(
        make_schedule("constant", 0.1), grad_clip=10.0))
    step = make_train_step(model)
    losses, step_ms, peak = [], [], 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    for i in range(steps):
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
        if per_step != expect:
            raise AssertionError(f"launches per step: {per_step}, expected "
                                 f"{expect}")
        losses.append(loss)
        if i >= warmup:
            step_ms.append(ms)
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(phase, **fields, step=i, loss=f"{loss:.6f}",
            grad_norm=f"{gnorm:.4f}", step_ms=f"{ms:.1f}",
            voxels_per_s=f"{n_voxels / ms * 1e3:.0f}", timed=i >= warmup,
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            launches=per_step)
    if state.step != steps:
        raise AssertionError(f"step counter {state.step}")
    return {"losses": losses, "step_ms": step_ms, "peak": peak,
            "resident": resident, "mean_ms": float(np.mean(step_ms))}


def check_trained(model, start, means, losses) -> None:
    """Every parameter has a gradient and moved, every running mean moved,
    the loss fell."""
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


def snapshot(model) -> tuple:
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: m.running_mean.clone() for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)})


def phase_training(model, np_batch, check_batch) -> dict:
    """Ten optimizer steps on one request; returns the launch counts."""
    batch = batch_to_torch(np_batch, device="cuda")
    n = valid_voxels(np_batch)
    start, means = snapshot(model)
    zero_launches()
    run = run_steps(model, batch, n, TRAIN_STEPS, TRAIN_WARMUP, "6 training",
                    {"segment_csr": FORWARD_LAUNCHES,
                     "segment_csr_bwd": BACKWARD_LAUNCHES})
    launches = dict(seg.LAUNCHES)
    check_trained(model, start, means, run["losses"])
    log("6 training", steps=TRAIN_STEPS, timed_steps=len(run["step_ms"]),
        params=sum(p.numel() for p in model.parameters()), voxels=n,
        first_loss=f"{run['losses'][0]:.4f}",
        last_loss=f"{run['losses'][-1]:.4f}",
        mean_step_ms=f"{run['mean_ms']:.1f}",
        min_step_ms=f"{min(run['step_ms']):.1f}",
        voxels_per_s=f"{n / run['mean_ms'] * 1e3:.0f}", launches=launches)
    model.eval()
    serve_one(model, check_batch, "6 training", after="training, eval mode")
    # the same step without tower remat (``flagship_spec`` asks for 'convs'):
    # what the default costs on the clock and saves in memory
    plain = MultimodalSeg(with_remat(model.spec, False), device="cuda",
                          seed=0)
    short = run_steps(plain, batch, n, TRAIN_WARMUP + NO_REMAT_STEPS,
                      TRAIN_WARMUP, "6 training",
                      {"segment_csr": FORWARD_LAUNCHES,
                       "segment_csr_bwd": BACKWARD_LAUNCHES}, remat=False)
    log("6 training", remat=False, timed_steps=NO_REMAT_STEPS,
        mean_step_ms=f"{short['mean_ms']:.1f}",
        min_step_ms=f"{min(short['step_ms']):.1f}",
        peak_mem_gib=f"{short['peak'] / 2**30:.2f}",
        over_resident_gib=f"{(short['peak'] - short['resident']) / 2**30:.2f}",
        convs_peak_mem_gib=f"{run['peak'] / 2**30:.2f}",
        convs_over_resident_gib=(
            f"{(run['peak'] - run['resident']) / 2**30:.2f}"),
        first_loss=f"{short['losses'][0]:.6f}")
    err = abs(short["losses"][0] - run["losses"][0]) / abs(run["losses"][0])
    if err > REMAT_LOSS_RTOL:
        raise AssertionError(f"remat changed the first loss: {err}")
    return launches


def phase_train_card_vs_cpu(model, np_batch, phase="7 train card vs cpu"
                            ) -> None:
    """One train step from identical weights on the card and on the CPU."""
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
    log(phase, voxels=valid_voxels(np_batch),
        loss=f"{loss:.6f}", cpu_loss=f"{ref_loss:.6f}",
        loss_rel_err=f"{loss_err:.3e}", grad_norm=f"{gnorm:.5f}",
        cpu_grad_norm=f"{ref_gnorm:.5f}", grad_norm_rel_err=f"{gnorm_err:.3e}")
    if not (loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GRAD_NORM_RTOL):
        raise AssertionError(
            f"card and CPU train steps disagree: {loss_err}, {gnorm_err}")


def phase_card_vs_cpu(model, np_batch, phase="4 card vs cpu") -> None:
    n = valid_voxels(np_batch)
    with torch.no_grad():
        card = model(batch_to_torch(np_batch, "cuda"))["logits"][:n].cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = cpu_model(batch_to_torch(np_batch, "cpu"))["logits"][:n]
    err = rel_err(card, cpu)
    agree = float((card.argmax(1) == cpu.argmax(1)).double().mean())
    log(phase, voxels=n, rel_err=f"{err:.3e}",
        argmax_agree=f"{agree:.5f}")
    if not (err <= LOGITS_RTOL and agree >= ARGMAX_AGREE):
        raise AssertionError(f"card and CPU disagree: {err}, {agree}")


# --- the recipe request (crop ladder) ----------------------------------------

def ladder_launches(np_batch) -> dict:
    """Kernel launches of one train step on a ladder batch with one branch:
    an atomic pool per bucket that holds an image, then the view pool's."""
    buckets = sum(int(im.shape[0]) > 0 for im in np_batch["bucket_images"])
    return {"segment_csr": buckets + VIEW_POOL_FORWARD,
            "segment_csr_bwd": buckets + VIEW_POOL_BACKWARD}


def with_remat(spec, remat):
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, remat_tower=remat))
        for lvl, b in spec.branches))


def check_recipe_request(np_batch) -> dict:
    """The request is the recipe's: every image in the largest bucket at
    full size, the smaller buckets one zero image and masked rows only."""
    images = np_batch["bucket_images"]
    buckets = np_batch["mappings"][0]["buckets"]
    rows = [int(b["pix_valid"].shape[0]) for b in buckets]
    live = [int(b["pix_valid"].sum()) for b in buckets]
    if tuple(images[-1].shape[1:3]) != RECIPE_IMAGE_SIZE or len(images) != 4:
        raise AssertionError(f"ladder {[tuple(i.shape) for i in images]}")
    if images[-1].shape[0] != 4 or any(live[:-1]) or live[-1] < 500_000:
        raise AssertionError(f"images {[i.shape[0] for i in images]}, live "
                             f"pixel rows {live}")
    if any(np.abs(im).max() != 0 for im in images[:-1]):
        raise AssertionError("a padding image is not zero")
    view = np_batch["mappings"][0]["view"]
    return dict(voxels=valid_voxels(np_batch),
                voxel_cap=int(np_batch["feats"].shape[0]),
                view_rows=int(view["view_valid"].shape[0]),
                valid_views=int(view["view_valid"].sum()),
                ladder="+".join(f"{i.shape[0]}x{i.shape[1]}x{i.shape[2]}"
                                for i in images),
                pixel_rows=rows, live_pixel_rows=live)


def phase_recipe_gather(batch) -> None:
    """The pixel gather of the largest bucket in its parts, forward and
    backward, by CUDA events (plain PyTorch with ordinary autograd; timing
    only).  ``index_select``, which the port's gathers use, differentiates
    through atomic adds; ``flat[idx]`` through ``index_put_`` with accumulate
    (a sort, deterministic)."""
    bucket = batch["mappings"][0]["buckets"][-1]
    images = batch["bucket_images"][-1]
    i_cap, (w, h) = images.shape[0], images.shape[1:3]
    wf, hf, c = w // 8, h // 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    maps = torch.randn(i_cap, wf, hf, c, generator=gen, device="cuda")
    img = bucket["pix_image"].clamp(0, i_cap - 1).to(torch.int64)
    px, py = bucket["pix_x"].to(torch.int64), bucket["pix_y"].to(torch.int64)
    rows = px.shape[0]
    used = pixel_gather._use_upsample(i_cap, w, h, c, rows, 4)
    idx = img * (w * h) + px.clamp(0, w - 1) * h + py.clamp(0, h - 1)
    mw = pixel_gather._resize_matrix(w, wf, "cuda")
    mh = pixel_gather._resize_matrix(h, hf, "cuda")

    def upsample(m):
        up = torch.einsum("aw,iwhc->iahc", mw, m)
        return torch.einsum("bh,iahc->iabc", mh, up).reshape(-1, c)

    flat = upsample(maps)
    g_rows = torch.randn(rows, c, generator=gen, device="cuda")
    g_flat = torch.randn_like(flat)
    leaf = maps.clone().requires_grad_()
    flat_leaf = flat.clone().requires_grad_()
    xf = px.float() / (w - 1) * wf - 0.5
    yf = py.float() / (h - 1) * hf - 0.5

    def backward_of(fn, inp, g):
        out = fn(inp)
        torch.cuda.synchronize()

        def run():
            inp.grad = None
            out.backward(g, retain_graph=True)

        return time_ms(run, iters=5)

    times = {
        "upsample_einsums_fwd": time_ms(lambda: upsample(maps), iters=5),
        "upsample_einsums_bwd": backward_of(upsample, leaf, g_flat),
        "row_gather_index_fwd": time_ms(lambda: flat[idx], iters=5),
        "row_gather_index_bwd_index_put": backward_of(
            lambda f: f[idx], flat_leaf, g_rows),
        "row_gather_index_select_fwd": time_ms(
            lambda: flat.index_select(0, idx), iters=5),
        "row_gather_index_select_bwd_atomics": backward_of(
            lambda f: f.index_select(0, idx), flat_leaf, g_rows),
        "four_tap_fwd": time_ms(
            lambda: pixel_gather._bilinear(maps, img, xf, yf), iters=5),
        "four_tap_bwd": backward_of(
            lambda m: pixel_gather._bilinear(m, img, xf, yf), leaf, g_rows),
    }
    log("8b recipe gather", rows=rows, channels=c, maps=f"{i_cap}x{wf}x{hf}",
        upsampled=f"{i_cap}x{w}x{h}",
        upsampled_gib=f"{flat.numel() * 4 / 2**30:.2f}",
        use_upsample=used, port_uses="upsample + index_select" if used
        else "four taps (index_select)",
        **{k + "_ms": f"{v:.3f}" for k, v in times.items()})
    if not used:
        raise AssertionError("the recipe shape did not take the upsample path")


def phase_recipe(model, trace: bool) -> dict:
    """Phases 8, 8a-8e: the crop-ladder path at the recipe's size."""
    t0 = time.perf_counter()
    np_batch, _, _ = recipe_batch(device="cuda")
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    shape = check_recipe_request(np_batch)
    log("8 recipe request", preprocess_ms=f"{prep_ms:.1f}", **shape)
    n = shape["voxels"]
    expect = ladder_launches(np_batch)
    batch = batch_to_torch(np_batch, device="cuda")

    # 8a: every kernel call of the path against its plain version
    calls = record_segment_calls(model, batch)
    if len(calls) != expect["segment_csr"]:
        raise AssertionError(f"{len(calls)} segment calls in one recipe "
                             f"forward, expected {expect['segment_csr']}")
    masked_out = [c for c in calls if c[2] is not None and not c[2].any()]
    if len(masked_out) != 3:
        raise AssertionError(f"{len(masked_out)} all-masked calls")
    fwd_totals = measure_forward_calls(calls, "8a recipe kernels",
                                       "calls_per_recipe_forward")
    del calls, masked_out
    train_model = copy.deepcopy(model).train()
    bwd_calls = record_backward_calls(train_model, batch)
    if len(bwd_calls) != expect["segment_csr_bwd"]:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             f"recipe step, expected "
                             f"{expect['segment_csr_bwd']}")
    bwd_totals = measure_backward_calls(bwd_calls, "8a recipe kernels")
    del bwd_calls, train_model
    torch.cuda.empty_cache()

    # 8b: the pixel gather in its parts
    phase_recipe_gather(batch)
    torch.cuda.empty_cache()

    # 8c: serving
    zero_launches()
    fwd_ms = [serve_one(model, np_batch, "8c recipe serving",
                        expect=expect["segment_csr"], batch=batch, forward=i,
                        timed=i > 0)
              for i in range(RECIPE_FORWARDS)][1:]
    serve_launches = dict(seg.LAUNCHES)
    if serve_launches["segment_csr_bwd"] != 0:
        raise AssertionError("serving launched the backward kernel")
    log("8c recipe serving", timed_forwards=len(fwd_ms),
        mean_forward_ms=f"{np.mean(fwd_ms):.1f}",
        min_forward_ms=f"{min(fwd_ms):.1f}",
        voxels_per_s=f"{n / np.mean(fwd_ms) * 1e3:.0f}",
        launches=serve_launches)

    # 8d: training under the three remat modes, from the same weights
    runs, train_launches, trained = {}, None, None
    for remat, steps, warmup in (("convs", RECIPE_STEPS, RECIPE_WARMUP),
                                 (False, RECIPE_SHORT_STEPS, RECIPE_WARMUP),
                                 (True, RECIPE_SHORT_STEPS, RECIPE_WARMUP)):
        m = MultimodalSeg(with_remat(model.spec, remat), device="cuda",
                          seed=0)
        start, means = snapshot(m)
        if not all(torch.equal(p, dict(model.named_parameters())[k])
                   for k, p in start.items()):
            raise AssertionError("the seeded weights differ from the serving "
                                 "model's")
        zero_launches()
        runs[remat] = run_steps(m, batch, n, steps, warmup,
                                "8d recipe training", expect, remat=remat)
        if remat == "convs":
            train_launches = dict(seg.LAUNCHES)
            check_trained(m, start, means, runs[remat]["losses"])
            trained = m
        else:
            del m
        del start, means
        torch.cuda.empty_cache()
    for remat, run in runs.items():
        log("8d recipe training", remat=remat, timed_steps=len(run["step_ms"]),
            mean_step_ms=f"{run['mean_ms']:.1f}",
            min_step_ms=f"{min(run['step_ms']):.1f}",
            voxels_per_s=f"{n / run['mean_ms'] * 1e3:.0f}",
            peak_mem_gib=f"{run['peak'] / 2**30:.2f}",
            over_resident_gib=f"{(run['peak'] - run['resident']) / 2**30:.2f}",
            first_loss=f"{run['losses'][0]:.6f}",
            second_loss=f"{run['losses'][1]:.6f}",
            last_loss=f"{run['losses'][-1]:.6f}")
    ref = runs[False]["losses"]
    for remat in ("convs", True):
        errs = [abs(a - b) / abs(b)
                for a, b in zip(runs[remat]["losses"][:2], ref[:2])]
        log("8d recipe training", remat=remat, against=False,
            first_loss_rel_err=f"{errs[0]:.3e}",
            second_loss_rel_err=f"{errs[1]:.3e}")
        if max(errs) > REMAT_LOSS_RTOL:
            raise AssertionError(f"remat {remat!r} changed the loss: {errs}")

    # 8e: card vs CPU on a small ladder batch, logits and one train step
    small, _, _ = recipe_batch(device="cuda", **LADDER_CHECK_REQUEST)
    ladder = [tuple(im.shape[1:3]) for im in small["bucket_images"]]
    if ladder != [(64, 32), (128, 64)]:
        raise AssertionError(f"small ladder {ladder}")
    phase_card_vs_cpu(model, small, "8e ladder card vs cpu")
    phase_train_card_vs_cpu(model, small, "8e ladder train card vs cpu")

    if trace:
        def forward():
            with torch.no_grad():
                model(batch)

        phase_trace("recipe_forward", forward)
        trained.train()
        state = TrainState.create(trained, make_optimizer(
            make_schedule("constant", 0.1), grad_clip=10.0))
        step = make_train_step(trained)
        step(state, batch, None)                   # warm-up, not traced
        phase_trace("recipe_train_step", lambda: step(state, batch, None))
    return {"forward": fwd_totals, "backward": bwd_totals,
            "serve_launches": serve_launches,
            "train_launches": train_launches}


class LoopProbe:
    """The seams of one ``cli.train.main`` run, patched for that run only:
    every train step (closed by a synchronisation: ms, loss, launches of
    each kernel), the consumer's wait in ``next()`` on the train loader and
    the batch's valid voxels, every eval epoch (ms), the cache build and the
    bucket probe (ms), the ``Trainer`` (its model's parameters as built)
    and the first train step's batch on the card (``batch``).
    ``on_fit(trainer)`` runs just before ``Trainer.fit``."""

    def __init__(self, on_fit=None):
        self.on_fit = on_fit
        self.losses, self.step_ms, self.step_launches = [], [], []
        self.wait_ms, self.train_images, self.eval_batches = [], [], 0
        self.train_voxels = []
        self.eval_ms, self.cache_ms, self.probe_ms = [], [], []
        self.bucket = self.trainer = self.start = self.batch = None
        self._undo = []

    def _patch(self, owner, name, make):
        original = getattr(owner, name)
        self._undo.append((owner, name, original))
        setattr(owner, name, make(original))

    def __enter__(self):
        from deepviewagg_tpu_torch.cli import train as cli
        from deepviewagg_tpu_torch.data.datasets import base, synthetic_ds
        from deepviewagg_tpu_torch.train import trainer

        probe = self

        def timed(into):
            def make(fn):
                def run(*args, **kwargs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    into.append((time.perf_counter() - t0) * 1e3)
                    return out
                return run
            return make

        def make_train_step(original):
            def build(*args, **kwargs):
                step = original(*args, **kwargs)

                def run(state, batch, generator):
                    if probe.batch is None:
                        probe.batch = batch
                    before = dict(seg.LAUNCHES)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch, generator)
                    torch.cuda.synchronize()
                    probe.step_ms.append((time.perf_counter() - t0) * 1e3)
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        raise AssertionError(
                            f"step {len(probe.losses)}: loss {loss}")
                    probe.losses.append(loss)
                    probe.step_launches.append(
                        {k: seg.LAUNCHES[k] - before[k] for k in before})
                    return state, metrics
                return run
            return build

        def init(original):
            def run(trainer_self, *args, **kwargs):
                original(trainer_self, *args, **kwargs)
                probe.trainer = trainer_self
                probe.start = {k: p.detach().clone() for k, p in
                               trainer_self.model.named_parameters()}
            return run

        def fit(original):
            def run(trainer_self, *args, **kwargs):
                if probe.on_fit is not None:
                    probe.on_fit(trainer_self)
                return original(trainer_self, *args, **kwargs)
            return run

        def loader_iter(original):
            def run(loader):
                it = original(loader)
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        if loader.dataset.train:
                            probe.wait_ms.append(
                                (time.perf_counter() - t0) * 1e3)
                            probe.train_images.append(
                                tuple(batch["images"].shape))
                            probe.train_voxels.append(valid_voxels(batch))
                        else:
                            probe.eval_batches += 1
                        yield batch
                finally:
                    it.close()
            return run

        def auto_bucket(original):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                probe.bucket = original(*args, **kwargs)
                probe.probe_ms.append((time.perf_counter() - t0) * 1e3)
                return probe.bucket
            return run

        self._patch(trainer, "make_train_step", make_train_step)
        self._patch(trainer.Trainer, "__init__", init)
        self._patch(trainer.Trainer, "fit", fit)
        self._patch(trainer.Trainer, "eval_epoch", timed(self.eval_ms))
        self._patch(base.BatchLoader, "__iter__", loader_iter)
        self._patch(synthetic_ds, "build_synthetic_cache",
                    timed(self.cache_ms))
        self._patch(cli, "auto_bucket", auto_bucket)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        return False

    def check_steps(self, phase: str) -> None:
        """Every step finite (checked as it ran) and through the flagship's
        kernel launches; every parameter on the card."""
        expect = {"segment_csr": FORWARD_LAUNCHES,
                  "segment_csr_bwd": BACKWARD_LAUNCHES}
        bad = [d for d in self.step_launches if d != expect]
        if not self.losses or bad:
            raise AssertionError(f"{phase}: {len(self.losses)} steps, "
                                 f"launches {bad[:2]} (expected {expect})")
        off = [k for k, p in self.trainer.model.named_parameters()
               if p.device.type != "cuda"]
        if off:
            raise AssertionError(f"{phase}: parameters off the card {off[:5]}")

    def summary(self) -> dict:
        waits = self.wait_ms
        return {
            "steps": len(self.losses),
            "first_step_ms": f"{self.step_ms[0]:.1f}",
            "mean_step_ms": f"{np.mean(self.step_ms[1:]):.1f}"
            if len(self.step_ms) > 1 else "n/a",
            "loader_wait_ms_first": f"{waits[0]:.1f}",
            "loader_wait_ms_mean_rest": f"{np.mean(waits[1:]):.1f}"
            if len(waits) > 1 else "n/a",
            "voxels_per_batch": f"{min(self.train_voxels)}-"
                                f"{max(self.train_voxels)} (mean "
                                f"{np.mean(self.train_voxels):.0f})",
            "eval_epoch_ms": "/".join(f"{t:.1f}" for t in self.eval_ms),
            "eval_batches": self.eval_batches,
            "first_loss": f"{self.losses[0]:.6f}",
            "last_loss": f"{self.losses[-1]:.6f}",
        }


def read_records(run_dir: Path) -> list:
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def state_matches(trainer, saved: dict) -> list:
    """Names of the model and optimizer tensors of ``trainer`` that differ
    from a saved checkpoint payload, bit for bit."""
    bad = [k for k, v in trainer.model.state_dict().items()
           if not torch.equal(v.cpu(), saved["model"][k])]
    tx = trainer.state.tx.state_dict()
    for i, (group, want) in enumerate(zip(tx["groups"],
                                          saved["optimizer"]["groups"])):
        for key in set(group) | set(want):
            if len(group.get(key, [])) != len(want.get(key, [])) or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(group[key],
                                                            want[key])):
                bad.append(f"optimizer/{i}/{key}")
    for key in ("count", "mini_step"):
        if tx[key] != saved["optimizer"][key]:
            bad.append(f"optimizer/{key}")
    if trainer.state.step != saved["step"]:
        bad.append("step")
    return bad


def loop_quick(cli, tmp: Path) -> dict:
    """9a: ``conf/synthetic.yaml`` (the Quick start) for two epochs with an
    eval each, then one resumed epoch."""
    run_dir = tmp / "quick_run"
    args = ["--config", str(CONF / "synthetic.yaml"),
            f"data.root={tmp / 'quick_data'}", f"training.run_dir={run_dir}",
            "training.eval_frequency=1", "training.tensorboard=false"]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args + [f"training.epochs={QUICK_EPOCHS}"])
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9a quick start")
    records = read_records(run_dir)
    if len(records) != QUICK_EPOCHS or not all("val_miou" in r
                                                for r in records):
        raise AssertionError(f"metrics.jsonl: {records}")
    for name in ("latest.pt", "best_val_miou.pt", "run.json", "best.json"):
        if not (run_dir / name).exists():
            raise AssertionError(f"{name} missing from the run dir")
    still = [k for k, p in probe.trainer.model.named_parameters()
             if torch.equal(p.detach(), probe.start[k])]
    if still:
        raise AssertionError(f"parameters that did not move: {still[:5]}")
    if not (launches["segment_csr"] > 0 and launches["segment_csr_bwd"] > 0):
        raise AssertionError(f"kernel launches did not rise: {launches}")
    log("9a quick start", model=probe.trainer.model.spec.backbone,
        params=sum(p.numel() for p in probe.trainer.model.parameters()),
        images=probe.train_images[0], **probe.summary(),
        val_miou="/".join(f"{r['val_miou']:.2f}" for r in records),
        launches=launches)

    saved = torch.load(run_dir / "latest.pt", map_location="cpu",
                       weights_only=True)
    restored = []

    def check_restored(trainer):
        restored.append(state_matches(trainer, saved))

    zero_launches()
    with LoopProbe(on_fit=check_restored) as resumed:
        cli.main(args + ["training.epochs=1", "training.resume=true"])
    resumed.check_steps("9a resume")
    if restored != [[]]:
        raise AssertionError(f"restored state differs from the saved one: "
                             f"{restored}")
    after = torch.load(run_dir / "latest.pt", map_location="cpu",
                       weights_only=True)["step"]
    if after != saved["step"] + len(resumed.losses):
        raise AssertionError(f"step {after} after resuming at "
                             f"{saved['step']} for {len(resumed.losses)} "
                             "steps")
    log("9a resume", restored_bit_equal=True, saved_step=saved["step"],
        steps=len(resumed.losses), step_after=after,
        launches=dict(seg.LAUNCHES))
    return launches


def loop_recipe(cli, tmp: Path) -> dict:
    """9b: ``conf/s3dis_benchmark.yaml`` on synthetic rooms: the recipe's
    model at its published widths, its batch, image slots and 2D size; then
    every sorted-segment call of the first train step's batch (forward in
    eval mode, backward in training mode, through the trained model) held
    against its plain version and timed as in phases 2 / 2b."""
    run_dir = tmp / "recipe_run"
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"), *RECIPE_LOOP,
            f"data.root={tmp / 'recipe_data'}", f"training.run_dir={run_dir}",
            "training.tensorboard=false"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9b recipe loop")
    spec = probe.trainer.model.spec
    (_, branch), = spec.branches
    if not (spec.backbone == "Res16UNet34" and branch.tower == "resnet18_l4"
            and branch.tower_deep_stem and branch.out_channels == 512
            and branch.num_groups == 4 and branch.fusion_mode == "concat"):
        raise AssertionError(f"not the recipe's model: {spec}")
    if any(shape[1:3] != RECIPE_IMAGE_SIZE for shape in probe.train_images):
        raise AssertionError(f"image batches {probe.train_images}")
    records = read_records(run_dir)
    if len(records) != 2 or not all("val_miou" in r for r in records):
        raise AssertionError(f"metrics.jsonl: {records}")
    b = probe.bucket
    log("9b recipe loop", model=probe.trainer.run_config["model"]["name"],
        params=sum(p.numel() for p in probe.trainer.model.parameters()),
        images=probe.train_images[0],
        cache_build_ms="/".join(f"{t:.0f}" for t in probe.cache_ms),
        probe_ms=f"{probe.probe_ms[0]:.0f}",
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        **probe.summary(),
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches_per_step=probe.step_launches[0], launches=launches,
        val_miou="/".join(f"{r['val_miou']:.2f}" for r in records))

    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    fwd = measure_forward_calls(calls, "9b recipe loop kernels",
                                "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             "step")
    bwd = measure_backward_calls(bwd_calls, "9b recipe loop kernels")
    del bwd_calls, model, batch
    return {"launches": launches, "forward": fwd, "backward": bwd}


def phase_loop() -> dict:
    """Phase 9: the experiment loop on the card, through the entry point a
    user calls (``cli.train.main``), in this process; data and run dirs
    under a temporary directory that is deleted afterwards."""
    from deepviewagg_tpu_torch.cli import train as cli

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    try:
        quick = loop_quick(cli, tmp)
        torch.cuda.empty_cache()
        recipe = loop_recipe(cli, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"quick": quick, "recipe": recipe}


def kernel_family(name: str) -> str:
    """Coarse family of a CUDA kernel name, for the trace summary."""
    low = name.lower()
    # cuDNN convs and cuBLAS GEMMs share "xmma"/"gemm" in their names; the
    # convs carry "conv", "fprop" or "implicit"
    # the forward's finish kernel starts while its tile kernel still runs
    # and waits for it, so its duration overlaps the tile kernel's
    for key, fam in (("segment_csr_bwd", "segment_csr_bwd (ours)"),
                     ("segment_csr_tile", "segment_csr tile kernel (ours)"),
                     ("segment_csr_finish", "segment_csr finish kernel "
                      "(ours; includes its wait for the tile kernel)"),
                     ("indexing_backward", "scatter-add (index_put "
                      "accumulate: autograd of x[idx])"),
                     ("index_put", "scatter-add (index_put accumulate: "
                      "autograd of x[idx])"),
                     ("indexfunc", "scatter-add (index_add atomics: "
                      "autograd of index_select, the pixel gather)"),
                     ("indexselect", "gather/scatter"),
                     ("conv", "conv2d"), ("fprop", "conv2d"),
                     ("implicit", "conv2d"), ("gemm", "matmul"),
                     ("index", "gather/scatter"), ("gather", "gather/scatter"),
                     ("scatter", "gather/scatter"), ("sort", "sort/search"),
                     ("search", "sort/search"), ("reduce", "reduction"),
                     ("norm", "norm"), ("rowwisemoments", "norm"),
                     ("upsample", "resize (PPM upsampling)"),
                     ("pool", "pooling"), ("copy", "copy/cast"),
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
    other: dict = {}
    for ev in prof.key_averages():
        # device-side events only: an operator's entry repeats its kernels'
        us = ev.self_device_time_total
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + us
            if fam == "other":
                other[ev.key] = other.get(ev.key, 0.0) + us
    busy = sum(fams.values())
    log("5 trace", what=what, repeats=repeats,
        wall_ms_each=f"{wall_us / repeats / 1e3:.2f}",
        device_ms_each=f"{busy / repeats / 1e3:.2f}",
        idle_share=f"{1 - busy / wall_us:.3f}")
    for fam, us in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("5 trace", what=what, family=fam,
            ms_each=f"{us / repeats / 1e3:.3f}", share=f"{us / busy:.3f}")
    for key, us in sorted(other.items(), key=lambda kv: -kv[1])[:4]:
        log("5 trace", what=what, family="other",
            kernel=key[:90].replace(" ", ""),
            ms_each=f"{us / repeats / 1e3:.3f}")


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
    tune = "--tune" in sys.argv[1:]
    device = phase_card()
    phase_build()
    t0 = time.perf_counter()
    model = MultimodalSeg(flagship_spec(), device="cuda", seed=0).eval()
    log("3 serving", model="flagship", params=sum(
        p.numel() for p in model.parameters()),
        build_s=f"{time.perf_counter() - t0:.1f}")
    requests = [make_request(seed, "cuda", **SERVE_REQUEST)
                for seed in range(3)]
    totals = phase_kernels(model, batch_to_torch(requests[0][0], "cuda"),
                           tune)
    launches = phase_serving(model, requests)
    check_request, _ = make_request(0, "cuda", **CHECK_REQUEST)
    phase_card_vs_cpu(model, check_request)
    # training runs on a copy, so the serving model keeps its weights
    train_model = copy.deepcopy(model).train()
    bwd_totals = phase_backward_kernels(
        train_model, batch_to_torch(requests[0][0], "cuda"))
    train_launches = phase_training(train_model, requests[0][0],
                                    requests[1][0])
    phase_train_card_vs_cpu(model, check_request)
    recipe = phase_recipe(model, trace)
    if trace:
        trace_forward_and_train(model, train_model, requests[0][0])
    del train_model
    torch.cuda.empty_cache()
    loop = phase_loop()

    def entry(name, source, replaces, totals, recipe_totals, loop_totals,
              **counts):
        keys = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
                "max_abs_err")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, **counts,
            "max_abs_err": max(totals["max_abs_err"],
                               recipe_totals["max_abs_err"],
                               loop_totals["max_abs_err"]),
            "ms": totals["ms"], "call_ms": totals["call_ms"],
            "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": "bytes",
            "library_ms": totals["library_ms"], "checked": True,
            "recipe": {k: recipe_totals[k] for k in keys},
            "loop_recipe": {k: loop_totals[k] for k in keys},
        }

    # ``launches``: the kernel's count over the path that drives it first
    # (serving for the forward, training for the backward); times are sums
    # over the calls of one forward / one train step: ``ms`` on the device,
    # ``call_ms`` through the wrapper; ``recipe``: the same sums over the
    # calls of one recipe forward / train step, ``launches_recipe_*``: the
    # counts over the recipe's serving and training runs;
    # ``loop_recipe``: the same sums over the calls of one forward / train
    # step of phase 9b's first batch, ``launches_loop_*``: the counts over
    # the first run of phase 9a (two epochs with evals) and over phase 9b
    loop_recipe = loop["recipe"]
    kernels = [
        entry("segment_csr", "deepviewagg_tpu_torch/csrc/segment_csr.cu",
              "deepviewagg_tpu/ops/pallas_segment.py:75", totals,
              recipe["forward"], loop_recipe["forward"],
              launches=launches["segment_csr"],
              launches_training=train_launches["segment_csr"],
              launches_recipe_serving=recipe["serve_launches"]["segment_csr"],
              launches_recipe_training=recipe["train_launches"]["segment_csr"],
              launches_loop_quick=loop["quick"]["segment_csr"],
              launches_loop_recipe=loop_recipe["launches"]["segment_csr"]),
        entry("segment_csr_bwd",
              "deepviewagg_tpu_torch/csrc/segment_csr_bwd.cu",
              "deepviewagg_tpu/ops/pallas_segment.py:177", bwd_totals,
              recipe["backward"], loop_recipe["backward"],
              launches=train_launches["segment_csr_bwd"],
              launches_recipe_training=recipe["train_launches"][
                  "segment_csr_bwd"],
              launches_loop_quick=loop["quick"]["segment_csr_bwd"],
              launches_loop_recipe=loop_recipe["launches"][
                  "segment_csr_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
