"""Padded-CSR primitives: the static-shape encodings of every ragged
("list-of-lists") relation.

The port of ``deepviewagg_tpu/core/csr.py``.  The reference keeps its
point -> view -> pixel relations in a nested CSR object graph (``CSRData``,
torch_points3d/core/multimodal/csr.py:44; ``ImageMapping``, image.py:1707);
here they are arrays of fixed capacity in three interchangeable encodings:

  * **pointers**  ``int32[G+1]`` — classic CSR group boundaries;
  * **segment ids** ``int32[E]`` — per-element group index, sorted ascending;
  * **validity masks** — padding elements carry ``segment_id == G`` (one past
    the last real group), so that a segment reduction can allocate ``G+1``
    slots and drop the last one.

:func:`pad_to` is host numpy (the collate's); the other helpers are torch
functions on their inputs' device, element for element the JAX package's,
dtypes included (``int32``).  torch has no ``lexsort``: :func:`lexsort_keys`
chains stable argsorts, the primary key last, so that ties order as
``jnp.lexsort`` orders them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pointers_to_segment_ids",
    "segment_ids_to_pointers",
    "counts_to_pointers",
    "pointers_to_counts",
    "insert_empty_groups",
    "lexsort_keys",
    "lexargsort",
    "lexunique_mask",
    "pad_to",
]


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def pointers_to_segment_ids(pointers, num_elements: int) -> torch.Tensor:
    """Expand CSR ``pointers[G+1]`` into per-element segment ids ``int32[E]``.

    Elements at positions >= ``pointers[-1]`` (padding) get id ``G`` so they
    fall into the drop row of a ``G+1``-slot segment reduction (the implicit
    group structure ``segment_csr`` walks in the reference,
    torch_points3d/modules/multimodal/pooling.py:7).
    """
    pointers = _int32(pointers)
    positions = torch.arange(num_elements, dtype=torch.int32,
                             device=pointers.device)
    # searchsorted(right) - 1 maps position -> owning group; positions past
    # pointers[-1] map to G (the pad group)
    ids = torch.searchsorted(pointers, positions, right=True,
                             out_int32=True) - 1
    return torch.clamp(ids, 0, pointers.shape[0] - 1)


def segment_ids_to_pointers(segment_ids, num_groups: int) -> torch.Tensor:
    """Compress sorted segment ids ``int32[E]`` into pointers ``int32[G+1]``.

    Padding ids (>= num_groups) land past the final pointer.  Ids must be
    sorted ascending (padding last).
    """
    segment_ids = _int32(segment_ids)
    groups = torch.arange(num_groups + 1, dtype=torch.int32,
                          device=segment_ids.device)
    return torch.searchsorted(segment_ids, groups, out_int32=True)


def counts_to_pointers(counts) -> torch.Tensor:
    """``int32[G]`` per-group counts -> ``int32[G+1]`` pointers."""
    counts = _int32(counts)
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


def pointers_to_counts(pointers) -> torch.Tensor:
    pointers = _int32(pointers)
    return pointers[1:] - pointers[:-1]


def insert_empty_groups(group_ids, num_groups: int,
                        num_elements: int) -> torch.Tensor:
    """Full-width pointers ``int32[num_groups+1]`` over elements whose
    sorted owning ids are ``group_ids[E]``: the reference's
    ``CSRData.insert_empty_groups`` (csr.py:197), which re-expands a CSR
    whose groups cover only the observed ids to the whole id range."""
    group_ids = _int32(group_ids)
    groups = torch.arange(num_groups + 1, dtype=torch.int32,
                          device=group_ids.device)
    ptr = torch.searchsorted(group_ids, groups, out_int32=True)
    return torch.clamp(ptr, max=num_elements)


def lexsort_keys(*keys) -> torch.Tensor:
    """Lexicographic argsort ``int32`` over keys, the last key primary (the
    order of ``jnp.lexsort``; the reference's ``lexargsort``,
    torch_points3d/utils/multimodal.py:36, packs the keys into one int64
    instead)."""
    keys = [torch.as_tensor(k) for k in keys]
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order.to(torch.int32)


def lexargsort(*keys) -> torch.Tensor:
    """The reference's naming, primary key FIRST: ``lexargsort(a, b)`` sorts
    by ``a`` then ``b`` (utils/multimodal.py:55)."""
    return lexsort_keys(*reversed(keys))


def lexunique_mask(*keys):
    """``(order, keep)``: ``order = lexargsort(*keys)`` and ``keep`` a bool
    mask over the *sorted* sequence marking rows that differ from their
    predecessor — the static-shape stand-in for ``lexunique``
    (utils/multimodal.py:70)."""
    order = lexargsort(*keys)
    idx = order.to(torch.int64)
    diff = torch.zeros(order.shape, dtype=torch.bool, device=order.device)
    for k in keys:
        k = torch.as_tensor(k)[idx]
        diff = diff | torch.cat([torch.ones(1, dtype=torch.bool,
                                            device=k.device), k[1:] != k[:-1]])
    return order, diff


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
