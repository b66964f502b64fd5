"""Spans, probes and the profiler's trace, all from the benchmark's side.

``Spans`` times the harness's calls into the program on the host clock and,
in a traced run, opens a ``record_function`` range ``bench::<name>`` around
each, so that the device trace can say what the host was doing in each idle
gap.  ``ModelProbe`` (traced runs) marks the forward, backward and optimizer
phases of a step and records CUDA events at the model's entry, at its 3D
stem and at its head: the image branches run between the first two, the
sparse UNet between the last two.  ``SegmentProbe`` counts the byte bound of
every call of the sorted-segment kernels; :func:`window_segment_bytes` runs
it after the window has closed, over the window's batches taken through the
train step once more, so that its own kernels stay out of the window.
``DeviceTrace`` runs ``torch.profiler`` over the window and reduces its
trace.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

from .counts import segment_bwd_bytes, segment_fwd_bytes

__all__ = ["Spans", "ModelProbe", "SegmentProbe", "window_segment_bytes",
           "DeviceTrace", "kernel_family", "reduce_trace"]


class Spans:
    """Host-clock durations (seconds) per span name, and the traced run's
    ``bench::`` ranges."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.times: Dict[str, List[float]] = defaultdict(list)
        self._open: Dict[str, object] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = self.enter(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)
            self.exit(name, rf)

    def enter(self, name: str):
        if not self.traced:
            return None
        rf = torch.autograd.profiler.record_function("bench::" + name)
        rf.__enter__()
        return rf

    def exit(self, name: str, rf) -> None:
        if rf is not None:
            rf.__exit__(None, None, None)

    def open(self, name: str) -> None:
        """A range that another call closes (``close``)."""
        if self.traced and name not in self._open:
            self._open[name] = self.enter(name)

    def close(self, name: str) -> None:
        rf = self._open.pop(name, None)
        self.exit(name, rf)


class ModelProbe:
    """Traced runs: the phases of each step as ``bench::`` ranges and the
    device-timeline milliseconds of the image branches and of the UNet per
    forward.  ``backward`` marks whether a backward pass follows each
    forward (training)."""

    def __init__(self, model, spans: Spans, optimizer=None,
                 backward: bool = True):
        self.spans = spans
        self.marks: List[List[torch.cuda.Event]] = []
        self._handles = []
        self._tx = optimizer
        self._backward = backward

        def event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def model_pre(mod, args):
            spans.close("backward")
            spans.open("forward")
            self.marks.append([event()])

        def stem_pre(mod, args):
            if self.marks and len(self.marks[-1]) == 1:
                self.marks[-1].append(event())

        def head_pre(mod, args):
            if self.marks and len(self.marks[-1]) == 2:
                self.marks[-1].append(event())

        def model_post(mod, args, out):
            spans.close("forward")
            if self._backward:
                spans.open("backward")

        self._handles = [model.register_forward_pre_hook(model_pre),
                         model.stem.register_forward_pre_hook(stem_pre),
                         model.head.register_forward_pre_hook(head_pre),
                         model.register_forward_hook(model_post)]
        if optimizer is not None:
            update = optimizer.update

            def wrapped():
                spans.close("backward")
                with spans.span("optimizer"):
                    return update()

            optimizer.update = wrapped

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        if self._tx is not None:
            del self._tx.update
        self.spans.close("backward")
        self.spans.close("forward")

    def device_ms(self) -> Dict[str, List[float]]:
        """Per forward: ``image_branch`` and ``unet`` device ms."""
        torch.cuda.synchronize()
        out = {"image_branch": [], "unet": []}
        for m in self.marks:
            if len(m) == 3:
                out["image_branch"].append(m[0].elapsed_time(m[1]))
                out["unet"].append(m[1].elapsed_time(m[2]))
        return out


class SegmentProbe:
    """The byte bound of every forward and backward call of the port's
    sorted-segment kernels, summed on the device, by wrapping the two entry
    points that launch them.  Its counting launches kernels of its own, so
    it never runs inside the measured window."""

    def __init__(self, segment_module):
        self.mod = segment_module
        self._fwd_bytes: List[torch.Tensor] = []
        self._bwd_bytes: List[torch.Tensor] = []
        self._orig = (segment_module._segment_csr_forward,
                      segment_module.segment_csr_bwd)
        fwd0, bwd0 = self._orig

        def fwd(x, ptr, valid, reduce):
            out = fwd0(x, ptr, valid, reduce)
            self._fwd_bytes.append(segment_fwd_bytes(x, ptr, valid))
            return out

        def bwd(g, x, out, ptr, valid, reduce, num_rows=None):
            gx = bwd0(g, x, out, ptr, valid, reduce, num_rows)
            self._bwd_bytes.append(segment_bwd_bytes(
                g, x, ptr, valid, reduce, gx.shape[0]))
            return gx

        segment_module._segment_csr_forward = fwd
        segment_module.segment_csr_bwd = bwd

    def remove(self) -> None:
        (self.mod._segment_csr_forward, self.mod.segment_csr_bwd) = self._orig

    def bytes(self):
        """(forward bytes, backward bytes) over every call."""
        f = float(torch.stack(self._fwd_bytes).sum()) if self._fwd_bytes \
            else 0.0
        b = float(torch.stack(self._bwd_bytes).sum()) if self._bwd_bytes \
            else 0.0
        return f, b


def window_segment_bytes(segment_module, batches, step):
    """(forward bytes, backward bytes) of the segment calls of a window
    that ran ``batches`` (in order; a batch that the window ran again is the
    same object again): each distinct batch taken once more through
    ``step(batch)`` (one train step) under a :class:`SegmentProbe`, after
    the window, its bytes counted as many times as the window ran it.  The
    bytes follow from a batch's tables alone, never from the weights."""
    runs, order = defaultdict(int), {}
    for b in batches:
        runs[id(b)] += 1
        order.setdefault(id(b), b)
    probe = SegmentProbe(segment_module)
    fwd = bwd = 0.0
    try:
        for key, b in order.items():
            f0, b0 = probe.bytes()
            step(b)
            f1, b1 = probe.bytes()
            fwd += runs[key] * (f1 - f0)
            bwd += runs[key] * (b1 - b0)
    finally:
        probe.remove()
    return fwd, bwd


# kernel families for the breakdown (the classification of the port's
# chip_smoke.py trace summary)
_FAMILIES = (
    ("segment_csr_bwd", "segment_csr_bwd"),
    ("segment_csr_tile", "segment_csr_tile"),
    ("segment_csr_finish", "segment_csr_finish"),
    ("indexing_backward", "scatter_add_index_put"),
    ("index_put", "scatter_add_index_put"),
    ("indexfunc", "scatter_add_index_add"),
    ("indexselect", "gather_scatter"),
    ("conv", "conv2d"), ("fprop", "conv2d"), ("dgrad", "conv2d"),
    ("wgrad", "conv2d"), ("implicit", "conv2d"), ("gemm", "matmul"),
    ("index", "gather_scatter"), ("gather", "gather_scatter"),
    ("scatter", "gather_scatter"), ("sort", "sort_search"),
    ("search", "sort_search"), ("reduce", "reduction"), ("norm", "norm"),
    ("rowwisemoments", "norm"), ("upsample", "resize"), ("pool", "pooling"),
    ("memcpy", "memcpy"), ("memset", "memset"), ("copy", "copy_cast"),
    ("cat", "copy_cast"), ("elementwise", "elementwise"),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for key, fam in _FAMILIES:
        if key in low:
            return fam
    return "other"


def _union(intervals):
    """Sorted disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host spans that name an idle gap, innermost first
_GAP_NAMES = ("optimizer", "backward", "forward", "to_device",
              "loader_wait", "vote", "step", "eval_step")


class DeviceTrace:
    """``torch.profiler`` over the measured window (``bench::window``)."""

    def __init__(self, spans: Spans, scratch_dir: str):
        from torch.profiler import ProfilerActivity, profile

        self.spans = spans
        self.path = os.path.join(scratch_dir, "window_trace.json")
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self._rf = self.spans.enter("window")
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.spans.exit("window", self._rf)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Dict:
        """The window's trace reduced by :func:`reduce_trace`."""
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return reduce_trace(events)


def _labels(host, w0, w1):
    """``[(start, end, label)]`` covering ``[w0, w1]``: each piece labelled
    by the innermost host span over it (the latest-starting one that holds
    it: the spans nest), ``other_host`` where none does."""
    # at equal starts the inner (shorter) span sorts later
    host = sorted((h for h in host if h[2] in _GAP_NAMES),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    cuts = sorted({w0, w1} | {t for a, b, _ in host for t in (a, b)
                              if w0 < t < w1})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid, label = (a + b) / 2, "other_host"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[k][1] > mid:
                label = host[k][2]
                break
            if mid - host[k][0] > 60e6:
                break
        out.append((a, b, label))
    return out


def reduce_trace(events) -> Dict:
    """A chrome trace's events reduced over the ``bench::window`` range:
    device busy seconds (the union of kernels, copies and sets), the ten
    largest kernel families, the device's idle seconds by the host span
    that held them (``bench::`` ranges, innermost first), and the device
    seconds of the segment kernels (forward: the union of the tile and
    finish kernels' intervals; backward)."""
    win = None
    dev, fwd, bwd = [], [], []
    fam: Dict[str, float] = defaultdict(float)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith("bench::"):
            s = float(e["ts"])
            host.append((s, s + float(e["dur"]), name[7:]))
            if name == "bench::window":
                win = (s, s + float(e["dur"]))
        elif cat in _DEVICE_CATS:
            s = float(e["ts"])
            dev.append(((s, s + float(e["dur"])), name))
    if win is None:
        raise RuntimeError("the trace holds no bench::window range")
    w0, w1 = win
    inside = []
    for (s, e), name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        fam[kernel_family(name)] += (e - s) * 1e-6
        low = name.lower()
        if "segment_csr_bwd" in low:
            bwd.append((s, e))
        elif "segment_csr" in low:
            fwd.append((s, e))
    busy = _union(inside)
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < w1:
        gaps.append((at, w1))
    idle: Dict[str, float] = defaultdict(float)
    pieces = _labels(host, w0, w1)
    k = 0
    for s, e in gaps:
        while k < len(pieces) and pieces[k][1] <= s:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < e:
            a, b, label = pieces[j]
            idle[label] += (min(b, e) - max(a, s)) * 1e-6
            j += 1
    top = sorted(fam.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": _length(busy) * 1e-6,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "segment_fwd_s": _length(_union(fwd)) * 1e-6,
        "segment_bwd_s": _length(_union(bwd)) * 1e-6,
    }
