"""Padded-CSR host helper: static-capacity padding of numpy arrays.

The port's counterpart of ``deepviewagg_tpu/core/csr.py::pad_to`` (the other
helpers there are device-side ``jnp`` code the port does not need: collate
ships CSR pointers, and the segment kernel consumes them directly).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_to"]


def pad_to(x: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad (or truncate) ``x`` along ``axis`` to static ``size``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, size)
        return x[tuple(idx)]
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, size - cur)
    return np.pad(x, pad_width, constant_values=fill)
