"""``data/collate.py``'s page-locked staging: :func:`stage` lays a batch's
array leaves in one host buffer, and :func:`batch_to_torch` sends them to a
card from it by non-blocking copies.

On the CPU: the layout as a pure function of the batch (one buffer, each
leaf at a multiple of ``STAGE_ALIGN`` bytes, apart from the others, with
its bytes, dtype and shape; the nesting of each collate route kept,
``meta`` the caller's object), on the four collate routes (the flat S3DIS
one, the S3DIS crop ladder, KITTI-360's camera-family ladder, PTv3's); the
CPU path of ``batch_to_torch`` as it was (no staging, no staged bytes
counted).  Marker ``card``: every leaf the card receives is bit-equal to
the pageable copy's, on the flat, KITTI-360 and PTv3 routes; a staging
buffer whose copies are still queued is not handed to the next batch; the
staged bytes are all the bytes sent.  The file imports no JAX, so that the
card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_staging.py -q -m card
"""

import functools
import os

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.data.collate import (STAGE_ALIGN, Bucket, Sample,
                                                batch_to_torch, collate,
                                                device_view, stage)
from deepviewagg_tpu_torch.data.toy import recipe_batch, toy_batch
from deepviewagg_tpu_torch.utils import trace
from torch_port_util import card, fake_kitti360_layout  # noqa: F401

KITTI360_CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf", "kitti360_benchmark.yaml")
ROUTES = ("flat", "ladder", "kitti360", "ptv3")


def _kitti360_batch(root):
    from deepviewagg_tpu_torch.cli import train as cli_train
    from deepviewagg_tpu_torch.config import run as trun
    from deepviewagg_tpu_torch.data.datasets.base import BatchLoader

    layout = fake_kitti360_layout(os.path.join(root, "raw"))
    cfg = trun.load_run_config(KITTI360_CONF, [
        f"data.root={layout}", "data.dataset=kitti360", "data.radius=4.0",
        "data.batch_size=2", "data.image_slots=2",
        "data.samples_per_epoch=2", "data.voxel_size=0.25",
        "data.image_size=[176, 47]",
        "data.kwargs={image_size: [176, 47], fisheye_size: [70, 70],"
        f" max_images: 8, cache_dir: {root}/cache}}"])
    ds = cli_train.build_dataset(cfg, train=True, device="cpu")
    bucket = cli_train.auto_bucket(cfg, ds, [0])
    it = iter(BatchLoader(ds, bucket, 2, [0], shuffle=True, seed=1))
    try:
        return next(it)
    finally:
        it.close()


def _ptv3_batch(seed=3):
    """A PTv3-route batch; every seed gives the same shapes."""
    rng = np.random.default_rng(seed)
    samples = []
    for n in (300, 9, 140):
        c = np.unique(rng.integers(0, 14, (n, 3)), axis=0)[:n]
        samples.append(Sample(
            coords=(c + rng.integers(-20, 20, 3)).astype(np.int32),
            feats=rng.normal(size=(len(c), 6)).astype(np.float32),
            labels=rng.integers(-1, 4, len(c)).astype(np.int32),
            pos=rng.normal(size=(len(c), 3)).astype(np.float32)))
    return collate(samples, Bucket(level_caps=[512, 512, 384, 256],
                                   num_batches=4),
                   conv0_kernel=5, graph="ptv3")


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """The collated numpy batch of each route (``meta`` kept), built once
    on first use."""

    @functools.lru_cache(maxsize=None)
    def build(route):
        if route == "flat":
            return toy_batch(density=60.0, device="cpu")[0]
        if route == "ladder":
            return recipe_batch(density=60.0, image_size=(128, 64),
                                min_size=16, device="cpu")[0]
        if route == "kitti360":
            return _kitti360_batch(str(tmp_path_factory.mktemp("kitti360")))
        return _ptv3_batch()

    torch.manual_seed(0)
    return build


def _leaves(node, path=()):
    """``(path, leaf)`` of every numpy array or tensor leaf outside
    ``meta``, in walk order."""
    if isinstance(node, dict):
        return [x for k, v in node.items() if k != "meta"
                for x in _leaves(v, path + (k,))]
    if isinstance(node, (list, tuple)):
        return [x for i, v in enumerate(node) for x in _leaves(v, path + (i,))]
    if isinstance(node, (np.ndarray, torch.Tensor)):
        return [(path, node)]
    return []


def _same_nesting(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            if k == "meta":
                assert b[k] is a[k]
            else:
                _same_nesting(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(b) is type(a) and len(b) == len(a)
        for u, v in zip(a, b):
            _same_nesting(u, v)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, torch.Tensor)
    else:
        assert b is a


def _bytes_equal(t: torch.Tensor, a: np.ndarray) -> bool:
    """The tensor holds ``a``'s dtype, shape and bytes (as the pageable
    copy of ``np.ascontiguousarray(a)`` does)."""
    want = np.ascontiguousarray(a)
    got = t.cpu().numpy()
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


@pytest.mark.parametrize("route", ROUTES)
def test_stage_lays_out_every_leaf_aligned_in_one_buffer(batches, route):
    batch = batches(route)
    staged = stage(batch)
    _same_nesting(batch, staged)
    arrays, views = _leaves(batch), _leaves(staged)
    assert [p for p, _ in arrays] == [p for p, _ in views]
    assert len(views) > 5
    base = views[0][1].untyped_storage().data_ptr()
    end = 0
    for (path, a), (_, t) in zip(arrays, views):
        assert t.untyped_storage().data_ptr() == base, path
        offset = t.data_ptr() - base
        assert offset % STAGE_ALIGN == 0 and offset >= end, path
        assert t.is_contiguous() and _bytes_equal(t, a), path
        end = offset + t.nbytes
    assert end <= views[0][1].untyped_storage().nbytes()
    if route == "ladder":
        assert isinstance(staged["bucket_images"], list)
        assert staged["mappings"][0]["buckets"][1]["pix_ptr"].dtype == \
            torch.int32
    if route == "kitti360":
        assert len(staged["bucket_images"]) == 2
        assert staged["mappings"][0]["buckets"][1]["pix_valid"].dtype == \
            torch.bool
    if route == "ptv3":
        assert staged["graph"]["conv0_nbr"].shape == (125, 512)
        assert isinstance(staged["graph"]["levels"], list)


def test_stage_copies_before_it_returns():
    """The caller may rewrite its arrays as soon as :func:`stage` returns;
    non-contiguous leaves land contiguous, a 0-d one as
    ``np.ascontiguousarray`` makes it, an empty one at an aligned offset,
    a non-array leaf kept."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    batch = {"t": a.T, "z": np.array(7, np.int64), "e": np.zeros((0, 3),
             np.int32), "m": np.array([True, False, True]), "n": 3,
             "meta": {"k": a}}
    staged = stage(batch)
    want = {k: np.ascontiguousarray(v).copy() for k, v in batch.items()
            if isinstance(v, np.ndarray)}
    a[:] = -1
    for k, w in want.items():
        assert _bytes_equal(staged[k], w), k
    assert staged["n"] == 3 and staged["meta"] is batch["meta"]
    assert staged["e"].shape == (0, 3)


def test_batch_to_torch_cpu_path_does_not_stage(batches):
    """On the CPU the tensors share the caller's contiguous arrays, as
    before, and a profiled run counts no bytes sent."""
    batch = device_view(batches("flat"))
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        moved = batch_to_torch(batch, "cpu")
    counters = trace.snapshot()["counters"]
    trace.reset()
    assert "h2d_bytes" not in counters
    assert "h2d_staged_bytes" not in counters
    assert np.shares_memory(moved["feats"].numpy(), batch["feats"])


# --- on the card --------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("route", ("flat", "kitti360", "ptv3"))
def test_card_staged_leaves_bit_equal_to_the_pageable_copy(card, batches,
                                                           route):
    batch = device_view(batches(route))
    moved = batch_to_torch(batch, card)
    _same_nesting(batch, moved)
    arrays, sent = _leaves(batch), _leaves(moved)
    assert [p for p, _ in arrays] == [p for p, _ in sent]
    for (path, a), (_, t) in zip(arrays, sent):
        pageable = torch.from_numpy(np.ascontiguousarray(a)).to(card)
        assert t.device == pageable.device, path
        assert t.dtype == pageable.dtype and t.shape == pageable.shape, path
        assert t.cpu().numpy().tobytes() == \
            pageable.cpu().numpy().tobytes(), path


@pytest.mark.card
def test_card_staging_buffer_outlives_its_queued_copies(card):
    """Batch A's copies wait behind a long kernel; batch B, of A's layout
    and other bytes, is staged meanwhile, then A's arrays are rewritten:
    after a synchronisation A's device tensors hold A's bytes."""
    a, b = _ptv3_batch(seed=3), _ptv3_batch(seed=4)
    assert [(p, x.shape, x.dtype) for p, x in _leaves(a)] == \
        [(p, x.shape, x.dtype) for p, x in _leaves(b)]
    want = [np.ascontiguousarray(x).copy() for _, x in _leaves(a)]
    assert sum(not np.array_equal(w, x)
               for w, (_, x) in zip(want, _leaves(b))) > 3
    stream = torch.cuda.current_stream(card)
    torch.cuda.synchronize(card)
    torch.cuda._sleep(2_000_000_000)
    moved_a = batch_to_torch(device_view(a), card)
    moved_b = batch_to_torch(device_view(b), card)
    assert not stream.query(), "the long kernel ended before B was staged"
    for _, x in _leaves(a):
        x.view(np.uint8)[...] = 0xA5
    torch.cuda.synchronize(card)
    for (path, t), w in zip(_leaves(moved_a), want):
        assert _bytes_equal(t, w), path
    for (path, t), (_, x) in zip(_leaves(moved_b), _leaves(b)):
        assert _bytes_equal(t, x), path


@pytest.mark.card
def test_card_every_byte_sent_is_staged(card, batches):
    batch = device_view(batches("kitti360"))
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        batch_to_torch(batch, card)
        torch.cuda.synchronize(card)
    counters = trace.snapshot()["counters"]
    trace.reset()
    total = sum(x.nbytes for _, x in _leaves(batch))
    assert counters["h2d_bytes"] == counters["h2d_staged_bytes"] == total
