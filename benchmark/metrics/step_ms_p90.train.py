"""The 90th percentile of ``step_ms.train``'s samples."""

import numpy as np


def read(run):
    t = run.spans.times.get("step") if run.spans else None
    if not t:
        return None
    return float(np.percentile(np.asarray(t) * 1e3, 90))
