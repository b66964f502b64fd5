"""Mean host milliseconds of ``batch_to_torch`` plus the train step (and the
loop's own bookkeeping), each closed by a synchronisation (traced run)."""

import numpy as np


def _mean_ms(run, name):
    t = run.spans.times.get(name) if run.spans else None
    return float(np.mean(t)) * 1e3 if t else None


def read(run):
    return _mean_ms(run, "step")
