"""Mean host milliseconds the loader thread took to produce a batch of the
training loop: the program's ``loader.produce`` span, from the hand-over of
the batch before to this one being ready, its wait on a full queue left out
(traced run)."""

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
    return float(np.mean(t["host_ms"])) if t else None
