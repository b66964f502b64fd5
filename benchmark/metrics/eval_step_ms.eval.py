"""Mean host milliseconds of one batch of the voting loop: ``batch_to_torch``,
the eval step, the logits' copy to the host and the votes, closed by a
synchronisation (traced run)."""

import numpy as np


def _mean_ms(run, name):
    t = run.spans.times.get(name) if run.spans else None
    return float(np.mean(t)) * 1e3 if t else None


def read(run):
    return _mean_ms(run, "eval_step")
