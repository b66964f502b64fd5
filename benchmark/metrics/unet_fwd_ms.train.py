"""Mean device-timeline milliseconds of the sparse UNet's forward per step:
from the 3D stem to the head, between CUDA events."""

import numpy as np


def read(run):
    t = run.extra.get("device_ms", {}).get("unet")
    return float(np.mean(t)) if t else None
