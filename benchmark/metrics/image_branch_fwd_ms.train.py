"""Mean device-timeline milliseconds of the image branches' forward per
step: from the model's entry to its 3D stem, between CUDA events."""

import numpy as np


def read(run):
    t = run.extra.get("device_ms", {}).get("image_branch")
    return float(np.mean(t)) if t else None
