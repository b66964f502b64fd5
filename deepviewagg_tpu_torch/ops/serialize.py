"""Space-filling-curve serialization of grid points, and attention patches.

The serialization of Point Transformer V3 (Wu et al., CVPR 2024; Pointcept's
``pointcept/models/utils/serialization``): every point of a batch gets four
codes, one per curve,

* ``z``: the Morton interleave of its grid coordinates ``g = (x, y, z)``,
  bit ``i`` of ``x`` at bit ``3i + 2``, of ``y`` at ``3i + 1``, of ``z`` at
  ``3i``; ``z-trans``: the same of ``(y, x, z)``;
* ``hilbert``: Skilling's transpose algorithm at ``depth`` bits (the
  inverse-undo pass over the axes, then the interleave read as a Gray code
  and decoded), as Pointcept's ``hilbert.encode`` computes it;
  ``hilbert-trans``: the same of ``(y, x, z)``;

with the point's sample index or-ed in above bit ``3 * depth``, so that
each sample's points are contiguous in every order.  ``order = argsort
(code)`` and ``inverse`` is its scatter.  Coarser levels shift the codes
(``code >> 3`` is the code of the parent cell ``g >> 1``), never recompute
them.

Attention runs over patches of ``K`` consecutive points of an order
(:func:`patch_indices`, Pointcept's ``get_padding_and_inverse``): a sample
longer than ``K`` has its last patch filled to ``K`` with copies of the
points just before it; a sample of ``K`` points or fewer is one patch of its
own length.  ``pad`` lists, per slot of the padded sequence, the position in
the order it reads; ``unpad`` the slot of each real position.

Everything here runs on the tensors' device with host-known sizes (no
synchronisation); the ``*_plain`` functions are the same results by plain
Python loops, for the tests.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ORDERS", "encode", "inverse_of", "patch_indices", "patch_runs",
           "z_order_plain", "hilbert_plain", "patch_indices_plain"]

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")

# the masks of the 21-bit Morton spread (bit i -> bit 3i)
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
           (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
           (2, 0x1249249249249249))


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x1FFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def _interleave(x, y, z) -> torch.Tensor:
    return (_spread(x) << 2) | (_spread(y) << 1) | _spread(z)


def _hilbert(x, y, z, depth: int) -> torch.Tensor:
    axes = [x.clone(), y.clone(), z.clone()]
    for b in range(depth - 1, 0, -1):
        q, p = 1 << b, (1 << b) - 1
        for d in range(3):
            on = (axes[d] & q) != 0
            axes[0] = torch.where(on, axes[0] ^ p, axes[0])
            t = torch.where(on, torch.zeros_like(axes[0]),
                            (axes[0] ^ axes[d]) & p)
            axes[d] = axes[d] ^ t
            axes[0] = axes[0] ^ t
    code = _interleave(*axes)
    for shift in (1, 2, 4, 8, 16, 32):
        code = code ^ (code >> shift)
    return code


def encode(grid: torch.Tensor, sample: torch.Tensor, depth: int,
           order: str) -> torch.Tensor:
    """int64 codes of ``grid [N, 3]`` (non-negative, under ``2 ** depth``)
    along the curve ``order``, the ``sample [N]`` index above bit ``3 *
    depth``."""
    if not 0 < depth <= 16:
        raise ValueError(f"serialization depth {depth} outside 1..16")
    g = grid.to(torch.int64)
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    if order.endswith("-trans"):
        x, y = y, x
    if order.startswith("z"):
        code = _interleave(x, y, z)
    elif order.startswith("hilbert"):
        code = _hilbert(x, y, z, depth)
    else:
        raise ValueError(order)
    return (sample.to(torch.int64) << (3 * depth)) | code


def inverse_of(order: torch.Tensor) -> torch.Tensor:
    """The scatter of each row of ``order`` (``inverse[order] = arange``)."""
    n = order.shape[1]
    ar = torch.arange(n, device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, ar)


def patch_runs(counts: Sequence[int],
               patch: int) -> List[Tuple[int, int, int]]:
    """The attention calls over a padded sequence of samples of ``counts``
    points: ``(first slot, patches, patch length)`` per call, one call per
    run of consecutive samples longer than ``patch`` (each cut into whole
    patches) and one per shorter sample (a patch of its own length)."""
    runs: List[Tuple[int, int, int]] = []
    at, joined = 0, False
    for c in map(int, counts):
        if c == 0:
            continue
        if c > patch:
            n = -(-c // patch)
            if joined:
                start, k, _ = runs[-1]
                runs[-1] = (start, k + n, patch)
            else:
                runs.append((at, n, patch))
            joined = True
            at += n * patch
        else:
            runs.append((at, 1, c))
            joined = False
            at += c
    return runs


def patch_indices(counts: Sequence[int], patch: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(pad, unpad, padded length)`` of samples with ``counts`` points
    (contiguous, in this order) cut into patches of ``patch``: ``pad[j]``
    the position that slot ``j`` reads, ``unpad[i]`` the slot of position
    ``i``."""
    c = np.asarray([int(v) for v in counts], np.int64)
    p = np.where(c > patch, -(-c // patch) * patch, c)
    off = np.concatenate([[0], np.cumsum(c)])
    offp = np.concatenate([[0], np.cumsum(p)])
    total, total_p = int(off[-1]), int(offp[-1])
    ct = torch.as_tensor(c, device=device)
    sample_p = torch.repeat_interleave(
        torch.arange(len(c), device=device), torch.as_tensor(p, device=device),
        output_size=total_p)
    local = torch.arange(total_p, device=device) \
        - torch.as_tensor(offp[:-1], device=device)[sample_p]
    base = torch.as_tensor(off[:-1], device=device)[sample_p]
    pad = torch.where(local < ct[sample_p], base + local,
                      base + local - patch)
    sample = torch.repeat_interleave(
        torch.arange(len(c), device=device), ct, output_size=total)
    unpad = torch.arange(total, device=device) + torch.as_tensor(
        offp[:-1] - off[:-1], device=device)[sample]
    return pad, unpad, total_p


# --- plain versions (tests) ------------------------------------------------

def z_order_plain(x: int, y: int, z: int, depth: int) -> int:
    code = 0
    for i in range(depth):
        code |= ((x >> i) & 1) << (3 * i + 2)
        code |= ((y >> i) & 1) << (3 * i + 1)
        code |= ((z >> i) & 1) << (3 * i)
    return code


def hilbert_plain(x: int, y: int, z: int, depth: int) -> int:
    """Pointcept's ``hilbert.encode`` of one point, bit array by bit array:
    the coordinates' bits most significant first, the undo pass, the bits
    read axis after axis within each level, then Gray decoded."""
    bits = [[(v >> (depth - 1 - b)) & 1 for b in range(depth)]
            for v in (x, y, z)]
    for b in range(depth):
        for d in range(3):
            on = bits[d][b]
            for j in range(b + 1, depth):
                if on:
                    bits[0][j] ^= 1
                elif bits[0][j] != bits[d][j]:
                    bits[0][j] ^= 1
                    bits[d][j] ^= 1
    stream = [bits[d][b] for b in range(depth) for d in range(3)]
    code, acc = 0, 0
    for g in stream:
        acc ^= g
        code = (code << 1) | acc
    return code


def patch_indices_plain(counts: Sequence[int], patch: int):
    """Pointcept's ``get_padding_and_inverse`` loop, in numpy."""
    c = np.asarray(counts, np.int64)
    p = np.where(c > patch, -(-c // patch) * patch, c)
    off = np.concatenate([[0], np.cumsum(c)])
    offp = np.concatenate([[0], np.cumsum(p)])
    pad = np.arange(offp[-1])
    unpad = np.arange(off[-1])
    for i in range(len(c)):
        unpad[off[i]:off[i + 1]] += offp[i] - off[i]
        if c[i] != p[i]:
            r = c[i] % patch
            pad[offp[i + 1] - patch + r:offp[i + 1]] = \
                pad[offp[i + 1] - 2 * patch + r:offp[i + 1] - patch]
        pad[offp[i]:offp[i + 1]] -= offp[i] - off[i]
    return pad, unpad
