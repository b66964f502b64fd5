"""Spans and counters inside the program, kept while a profiler runs.

The program marks its layers with :func:`span`: the loader thread's
produce, sample and collate, the train step's forward, backward and
optimizer, the image branch's tower, gather and pools, and the like.  A
span records only while a ``torch.profiler`` runs, whichever it is: an
operator's profiled epoch (``TrainerConfig.profile_epochs``) or a
benchmark's traced window.  It then keeps, in memory: its name, its thread,
its parent (the span open on the same thread when it began), the index of
the batch its thread is on (:func:`set_batch`), its host time on
``time.perf_counter_ns``, its thread's CPU time (``time.thread_time_ns``),
and, given a CUDA tensor, the device time between two CUDA events recorded
on that tensor's stream.  It also opens a ``record_function`` range
``dva::<name>``, so that the profiler's trace holds it beside the device's
events.  With no profiler running, :func:`span` returns one shared object
that does nothing: no allocation, no clock read, no CUDA call.  A span is
kept only if a profiler ran both when it began and when it ended, so the
spans kept are those inside the profiled window: one that the window's
end cuts (say, a batch the loader thread was producing) is dropped, and
its children that ended inside the window keep a parent id that no kept
span has.

:func:`count` adds to a named counter while a profiler runs.
:func:`snapshot` resolves the CUDA events (one synchronisation) and returns
every span and counter kept so far; :func:`reset` forgets them.  Nothing is
written anywhere: a reader takes the snapshot.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["enabled", "span", "count", "set_batch", "snapshot", "reset"]

# the fields of each span name in a snapshot, one entry per span kept
FIELDS = ("id", "parent_id", "parent", "thread", "batch", "start_ms",
          "host_ms", "cpu_ms", "device_ms")

_lock = threading.Lock()
_records: List["_Record"] = []
_counters: Dict[str, int] = {}
_ids = itertools.count()
_local = threading.local()


def enabled() -> bool:
    """True while a ``torch.profiler`` runs (the flag is process-wide, so
    every thread sees it)."""
    return _profiler._is_profiler_enabled


class _Off:
    """What :func:`span` returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Record:
    __slots__ = ("id", "name", "thread", "parent_id", "parent", "batch",
                 "t0", "t1", "cpu_ns", "device")

    def row(self):
        """The snapshot's fields (the device's events resolved to ms)."""
        return {"id": self.id, "parent_id": self.parent_id,
                "parent": self.parent, "thread": self.thread,
                "batch": self.batch, "start_ms": self.t0 * 1e-6,
                "host_ms": (self.t1 - self.t0) * 1e-6,
                "cpu_ms": self.cpu_ns * 1e-6, "device_ms": self.device}


class _Span:
    __slots__ = ("rec", "_rf", "_c0", "_stream", "_events")

    def __init__(self, name: str, device):
        stack = _stack()
        parent = stack[-1].rec if stack else None
        rec = self.rec = _Record()
        rec.id = next(_ids)
        rec.name = name
        rec.thread = threading.current_thread().name
        rec.parent_id = None if parent is None else parent.id
        rec.parent = None if parent is None else parent.name
        rec.batch = getattr(_local, "batch", None)
        rec.device = None
        self._events = self._stream = None
        if isinstance(device, torch.Tensor) and device.is_cuda:
            self._stream = torch.cuda.current_stream(device.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        _stack().append(self)
        self._rf = _profiler.record_function("dva::" + self.rec.name)
        self._rf.__enter__()
        if self._events is not None:
            self._events[0].record(self._stream)
        self._c0 = time.thread_time_ns()
        self.rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        rec.cpu_ns = time.thread_time_ns() - self._c0
        kept = _profiler._is_profiler_enabled
        if self._events is not None and kept:
            self._events[1].record(self._stream)
            rec.device = self._events
        self._rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if kept:
            _records.append(rec)
        return False


def span(name: str, device=False):
    """A context manager marking ``name``'s work.  ``device``: a tensor on
    whose stream two CUDA events time the span on the device (a CUDA tensor
    only; anything else times the host alone)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def set_batch(index: Optional[int]) -> None:
    """The index, within its pass, of the batch this thread works on from
    now: the spans it opens carry it."""
    _local.batch = index


def snapshot() -> Dict:
    """Every span and counter kept since the last :func:`reset`:
    ``{"spans": {name: {field: [one value per span]}}, "counters": {name:
    n}, "segment_launches": ops.segment.LAUNCHES as it stands}``, the fields
    being :data:`FIELDS`: the span's id and its parent's id and name, its
    thread's name, its batch index, its start on ``perf_counter`` (ms), its
    host and CPU ms, and its device ms (None where it has no events).  The
    CUDA events still pending are resolved after one synchronisation."""
    from ..ops.segment import LAUNCHES

    records = list(_records)
    with _lock:
        counters = dict(_counters)
    pending = [r for r in records if isinstance(r.device, tuple)]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            start, end = r.device
            r.device = start.elapsed_time(end)
    spans: Dict[str, Dict[str, list]] = {}
    for r in records:
        out = spans.setdefault(r.name, {f: [] for f in FIELDS})
        for f, v in r.row().items():
            out[f].append(v)
    return {"spans": spans, "counters": counters,
            "segment_launches": dict(LAUNCHES)}


def reset() -> None:
    """Forgets every span and counter kept so far."""
    with _lock:
        _records.clear()
        _counters.clear()
