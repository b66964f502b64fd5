"""The loader thread's CPU seconds over the wall seconds of its
``loader.produce`` spans in the training loop, in %: below 100 where the
thread waits, for the interpreter lock among others (traced run)."""

import numpy as np


def _spans():
    """The program's spans of the traced window (``utils/trace.py``); empty
    for a program without that tracer."""
    try:
        from deepviewagg_tpu_torch.utils.trace import snapshot
    except ImportError:
        return {}
    return snapshot()["spans"]


def read(run):
    t = _spans().get("loader.produce")
    if not t or sum(t["host_ms"]) <= 0:
        return None
    return 100.0 * sum(t["cpu_ms"]) / sum(t["host_ms"])
