"""Host milliseconds per batch of the training loop that the loader thread
spent in ``collate``: the ``loader.collate`` span of each
``loader.produce``, averaged over the batches (traced run)."""

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
    if "loader.produce" not in spans or "loader.collate" not in spans:
        return None
    per = dict.fromkeys(spans["loader.produce"]["id"], 0.0)
    t = spans["loader.collate"]
    for parent, ms in zip(t["parent_id"], t["host_ms"]):
        if parent in per:
            per[parent] += ms
    return float(np.mean(list(per.values())))
