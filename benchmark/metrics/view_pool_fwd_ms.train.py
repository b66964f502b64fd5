"""Device milliseconds per train forward of the view pools (views to points),
modality dropout and fusion: the ``branch.view_pool`` spans' CUDA events
under each ``step.forward`` summed (every branch, every camera or crop
bucket), averaged over the forwards (traced run)."""

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
    spans = _spans()
    if "step.forward" not in spans or "branch.view_pool" not in spans:
        return None
    parent = {}
    for t in spans.values():
        parent.update(zip(t["id"], t["parent_id"]))
    per = dict.fromkeys(spans["step.forward"]["id"], 0.0)
    t = spans["branch.view_pool"]
    timed = False
    for i, ms in zip(t["id"], t["device_ms"]):
        up = parent.get(i)
        while up is not None and up not in per:
            up = parent.get(up)
        if ms is not None and up is not None:
            per[up] += ms
            timed = True
    return float(np.mean(list(per.values()))) if timed else None
