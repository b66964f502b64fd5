"""The eleven helpers that nothing in either package calls, against the JAX
package's: ``core/csr.py``'s eight CSR and lexicographic-sort helpers,
``ops/sparse_conv.py::sparse_gather``, ``metrics/confusion.py::
confusion_update`` and ``utils/logging.py::git_info``, on the same numpy
inputs.  Every result is byte-equal, dtype (``int32``) included."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.core import csr as jcsr
from deepviewagg_tpu.metrics import confusion as jconf
from deepviewagg_tpu.ops import sparse_conv as jsc
from deepviewagg_tpu.utils import logging as jlog
from deepviewagg_tpu_torch.core import csr as tcsr
from deepviewagg_tpu_torch.metrics import confusion as tconf
from deepviewagg_tpu_torch.ops import sparse_conv as tsc
from deepviewagg_tpu_torch.utils import logging as tlog

ROOT = Path(__file__).resolve().parents[1]


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def _pointers(seed, groups=9, empty=True):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, groups)
    if empty:
        counts[[0, 4]] = 0
    return counts.astype(np.int32), np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pointer_helpers_match_jax(seed):
    counts, ptr = _pointers(seed)
    _same(tcsr.counts_to_pointers(counts), jcsr.counts_to_pointers(counts))
    _same(tcsr.pointers_to_counts(ptr), jcsr.pointers_to_counts(ptr))
    for n in (int(ptr[-1]), int(ptr[-1]) + 7):   # without and with padding
        ids = jcsr.pointers_to_segment_ids(ptr, n)
        _same(tcsr.pointers_to_segment_ids(torch.from_numpy(ptr), n), ids)
        _same(tcsr.segment_ids_to_pointers(np.asarray(ids), len(counts)),
              jcsr.segment_ids_to_pointers(ids, len(counts)))


@pytest.mark.parametrize("num_elements", [6, 10, 40])
def test_insert_empty_groups_matches_jax(num_elements):
    ids = np.sort(np.random.default_rng(2).choice([1, 3, 3, 4, 7, 7, 7], 10))
    ids = ids.astype(np.int32)
    _same(tcsr.insert_empty_groups(ids, 9, num_elements),
          jcsr.insert_empty_groups(ids, 9, num_elements))


@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_lexsort_helpers_match_jax(nkeys):
    """Keys with many ties (values 0-3 over 200 rows), so that the order of
    equal rows is held too."""
    rng = np.random.default_rng(nkeys)
    keys = [rng.integers(0, 4, 200).astype(np.int32) for _ in range(nkeys)]
    tkeys = [torch.from_numpy(k) for k in keys]
    _same(tcsr.lexsort_keys(*tkeys), jcsr.lexsort_keys(*keys))
    _same(tcsr.lexargsort(*tkeys), jcsr.lexargsort(*keys))
    for got, want in zip(tcsr.lexunique_mask(*tkeys),
                         jcsr.lexunique_mask(*keys)):
        _same(got, want)


@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_sparse_gather_matches_jax(fill):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(12, 5)).astype(np.float32)
    # in range, at and past the end, negative; one and two index axes
    for idx in (np.array([0, 11, 12, 40, 3, -1, -13], np.int32),
                rng.integers(-20, 20, (4, 6)).astype(np.int32)):
        _same(tsc.sparse_gather(torch.from_numpy(feats), torch.from_numpy(idx),
                                fill),
              jsc.sparse_gather(jnp.asarray(feats), jnp.asarray(idx), fill))


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_update_matches_jax(masked):
    rng = np.random.default_rng(4)
    preds = rng.integers(0, 6, 500).astype(np.int32)
    labels = rng.integers(-1, 6, 500).astype(np.int32)
    valid = rng.random(500) < 0.7 if masked else None
    got = tconf.confusion_update(6, torch.from_numpy(preds),
                                 torch.from_numpy(labels),
                                 None if valid is None
                                 else torch.from_numpy(valid))
    _same(got, jconf.confusion_update(6, jnp.asarray(preds),
                                      jnp.asarray(labels),
                                      None if valid is None
                                      else jnp.asarray(valid)))
    cm = tconf.ConfusionMatrix(6)
    cm.add(preds, labels, valid)
    assert np.array_equal(got.numpy(), cm.m)


@pytest.mark.parametrize("where", ["repo", "not_a_repo"])
def test_git_info_matches_jax(where, tmp_path):
    repo_dir = str(ROOT) if where == "repo" else str(tmp_path)
    got = tlog.git_info(repo_dir)
    assert got == jlog.git_info(repo_dir)
    assert set(got) <= {"sha", "dirty"}
