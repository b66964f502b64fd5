"""Mean host milliseconds of the train step's ``step.optimizer`` span: the
host's time issuing the gradient norm and the update, synchronisations
included (traced run)."""

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
    t = _spans().get("step.optimizer")
    return float(np.mean(t["host_ms"])) if t else None
