"""Mean host milliseconds the voting loop waited in the loader's ``next()``
per batch."""

import numpy as np


def _mean_ms(run, name):
    t = run.spans.times.get(name) if run.spans else None
    return float(np.mean(t)) * 1e3 if t else None


def read(run):
    return _mean_ms(run, "loader_wait")
