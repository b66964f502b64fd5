"""The port's tracer (``utils/trace.py``), its spans in the loader, the
steps and the model, and the benchmark's readers of them, on the CPU."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepviewagg_tpu_torch.data.collate import Bucket, batch_to_torch
from deepviewagg_tpu_torch.data.datasets.base import BatchLoader
from deepviewagg_tpu_torch.data.datasets.synthetic_ds import (
    make_synthetic_dataset)
from deepviewagg_tpu_torch.data.toy import (flagship_spec, recipe_batch,
                                            toy_batch)
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.train.trainer import Trainer, TrainerConfig
from deepviewagg_tpu_torch.utils import trace
from torch_port_util import (TINY_BATCH, TINY_SPEC,  # noqa: F401
                             _torch_threads, assert_identical)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = Bucket(level_caps=[4096, 2048, 1024, 512, 256], num_batches=2,
                view_cap=4096, pix_cap=16384, image_cap=4,
                image_size=(64, 32))


@pytest.fixture(autouse=True)
def _fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def _spec():
    spec = flagship_spec(**TINY_SPEC)
    # this CPU's bfloat16 convolutions are not trusted: float32 towers
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, tower_bf16=False))
        for lvl, b in spec.branches))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = make_synthetic_dataset(
        str(tmp_path_factory.mktemp("trace_cache")), train=True, n_areas=1,
        radius=1.5, voxel_size=0.15, image_slots=2, samples_per_epoch=6,
        device="cpu", density=30.0, n_cameras=2, image_size=(64, 32))
    # the recipe's 2D augmentations, so that every sample span has work
    ds.flip_p, ds.jitter_mapping = 0.5, 0.02
    ds.color_jitter = (0.6, 0.6, 0.7)
    return ds


def _loader(ds, seed=3):
    ds._rng = np.random.default_rng(7)
    return BatchLoader(ds, BUCKET, 2, [0], seed=seed)


# --- off ---------------------------------------------------------------------

def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(trace._profiler, "record_function",
                        lambda name: opened.append(name))
    assert not trace.enabled()
    a, b = trace.span("a"), trace.span("b", device=torch.zeros(1))
    assert a is b
    with a, b:
        trace.count("c", 5)
    batch, _, _ = toy_batch(**TINY_BATCH, device="cpu")
    batch_to_torch({k: v for k, v in batch.items() if k != "meta"}, "cpu")
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert opened == []


def test_enabled_from_a_worker_thread_while_a_profiler_runs():
    """Pins the process-wide flag ``torch.autograd.profiler.
    _is_profiler_enabled`` that ``enabled()`` reads: a torch that drops it
    fails here."""
    seen = []

    def look():
        seen.append(trace.enabled())

    look()
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    look()
    assert seen == [False, True, False]


def test_counters_count_only_while_on_and_reset_clears():
    trace.count("n", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("n", 2)
        trace.count("n")
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    trace.count("n", 7)
    snap = trace.snapshot()
    assert snap["counters"] == {"n": 3}
    assert set(snap["segment_launches"]) == {"segment_csr", "segment_csr_bwd"}
    inner, outer = snap["spans"]["inner"], snap["spans"]["outer"]
    assert inner["parent"] == ["outer"] and outer["parent"] == [None]
    assert inner["parent_id"] == outer["id"]
    assert inner["device_ms"] == [None]
    assert inner["host_ms"][0] <= outer["host_ms"][0]
    trace.reset()
    assert trace.snapshot()["spans"] == {}


def test_a_span_cut_by_the_end_of_the_window_is_not_kept():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    cut = trace.span("cut")
    cut.__enter__()
    with trace.span("inside"):
        pass
    prof.__exit__(None, None, None)
    cut.__exit__(None, None, None)
    with trace.span("after"):
        pass
    spans = trace.snapshot()["spans"]
    assert set(spans) == {"inside"}
    assert spans["inside"]["parent"] == ["cut"]
    # the thread's stack is clean again
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("next"):
            pass
    assert trace.snapshot()["spans"]["next"]["parent"] == [None]


# --- the train step and the model --------------------------------------------

def _one_step(kind):
    if kind == "flat":
        batch, _, _ = toy_batch(**TINY_BATCH, device="cpu")
    else:
        batch, _, _ = recipe_batch(n_samples=1, density=20.0,
                                   image_size=(64, 32), n_cameras=1,
                                   voxel_size=0.15, min_size=16, device="cpu")
    model = MultimodalSeg(_spec(), device="cpu", seed=0)
    state = tstep.TrainState.create(model, topt.make_optimizer(
        topt.make_schedule("constant", 0.1), optimizer="sgd"))
    step = tstep.make_train_step(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dev = batch_to_torch({k: v for k, v in batch.items()
                              if k != "meta"}, "cpu")
        step(state, dev, None)
    return trace.snapshot(), prof


@pytest.mark.parametrize("kind", ["flat", "ladder"])
def test_train_step_records_its_spans_with_their_parents(kind, tmp_path):
    snap, prof = _one_step(kind)
    spans = snap["spans"]
    parents = {name: set(s["parent"]) for name, s in spans.items()}
    assert parents == {
        "to_device": {None}, "step.forward": {None},
        "step.backward": {None}, "step.optimizer": {None},
        "model.branch": {"step.forward"}, "model.unet": {"step.forward"},
        "branch.tower": {"model.branch"}, "branch.gather": {"model.branch"},
        "branch.atomic_pool": {"model.branch"},
        "branch.view_pool": {"model.branch"}}
    # one tower, gather and atomic pool a crop bucket on the ladder path
    n_buckets = 1 if kind == "flat" else 2
    for name in ("branch.tower", "branch.gather", "branch.atomic_pool"):
        assert len(spans[name]["id"]) == n_buckets
    for name in ("step.forward", "model.branch", "branch.view_pool"):
        assert len(spans[name]["id"]) == 1
    branch = spans["model.branch"]["host_ms"][0]
    parts = sum(sum(spans[n]["host_ms"]) for n in (
        "branch.tower", "branch.gather", "branch.atomic_pool",
        "branch.view_pool"))
    assert parts <= branch <= spans["step.forward"]["host_ms"][0]
    assert all(v is None for s in spans.values() for v in s["device_ms"])
    assert all(t == threading.current_thread().name
               for s in spans.values() for t in s["thread"])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"dva::step.forward", "dva::step.backward",
            "dva::step.optimizer", "dva::model.branch",
            "dva::branch.tower"} <= names


def test_eval_step_records_eval_forward():
    batch, _, _ = toy_batch(**TINY_BATCH, device="cpu")
    model = MultimodalSeg(_spec(), device="cpu", seed=0)
    dev = batch_to_torch({k: v for k, v in batch.items() if k != "meta"},
                         "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        tstep.make_eval_step(model)(None, dev)
    spans = trace.snapshot()["spans"]
    assert spans["eval.forward"]["parent"] == [None]
    assert set(spans["model.branch"]["parent"]) == {"eval.forward"}
    assert "step.forward" not in spans


# --- the loader --------------------------------------------------------------

def test_loader_records_one_produce_a_batch_on_its_thread(dataset):
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(_loader(dataset))
    snap = trace.snapshot()
    spans = snap["spans"]
    produce = spans["loader.produce"]
    n = len(batches)
    assert n >= 2 and len(produce["id"]) == n
    assert set(produce["thread"]) == {"BatchLoader"}
    assert produce["batch"] == list(range(n))
    assert produce["parent"] == [None] * n
    assert snap["counters"]["loader.batches"] == n
    # the consumer's gets: one a batch and the end of the pass
    get = spans["loader.get"]
    assert get["batch"] == list(range(n + 1))
    assert set(get["thread"]) == {threading.current_thread().name}
    assert len(spans["loader.put_wait"]["id"]) == n
    for name in ("loader.sample", "loader.collate", "sample.select3d",
                 "sample.images", "sample.normalize", "collate.graph",
                 "collate.mappings", "collate.images"):
        assert set(spans[name]["thread"]) == {"BatchLoader"}, name
    assert set(spans["loader.sample"]["parent"]) == {"loader.produce"}
    assert set(spans["loader.collate"]["parent"]) == {"loader.produce"}
    assert set(spans["sample.images"]["parent"]) == {"loader.sample"}
    assert set(spans["collate.graph"]["parent"]) == {"loader.collate"}
    # each produce holds its samples and its collate
    for pid, ms, k in zip(produce["id"], produce["host_ms"],
                          produce["batch"]):
        inside = sum(m for name in ("loader.sample", "loader.collate")
                     for p, m in zip(spans[name]["parent_id"],
                                     spans[name]["host_ms"]) if p == pid)
        assert 0 < inside <= ms
        collates = [b for p, b in zip(spans["loader.collate"]["parent_id"],
                                      spans["loader.collate"]["batch"])
                    if p == pid]
        assert collates == [k]


def test_loader_records_a_split_under_its_produce(dataset):
    caps = dataclasses.replace(BUCKET, level_caps=[96, 2048, 1024, 512, 256])
    dataset._rng = np.random.default_rng(7)
    loader = BatchLoader(dataset, caps, 2, [0], seed=3)
    with profile(activities=[ProfilerActivity.CPU]):
        list(loader)
    spans = trace.snapshot()["spans"]
    assert loader.stats["split"] > 0
    assert set(spans["loader.split"]["parent"]) == {"loader.produce"}
    # one span a split sample, however deep its bisection went
    assert len(spans["loader.split"]["id"]) <= loader.stats["split"]


def test_batches_are_identical_with_the_tracer_on_and_off(dataset):
    off = list(_loader(dataset))
    with profile(activities=[ProfilerActivity.CPU]):
        on = list(_loader(dataset))
    assert trace.snapshot()["spans"]["loader.produce"]
    assert len(on) == len(off) >= 2
    for a, b in zip(off, on):
        assert list(a) == list(b)
        ma, mb = a.pop("meta"), b.pop("meta")
        assert_identical(a, b)
        assert ma["sizes"] == mb["sizes"] and ma["clouds"] == mb["clouds"]
        assert_identical(ma["origin_ids"], mb["origin_ids"])


def test_profiled_epoch_exports_the_loader_thread(dataset, tmp_path):
    model = MultimodalSeg(_spec(), device="cpu", seed=0)
    tr = Trainer(model, 4, TrainerConfig(
        epochs=1, run_dir=str(tmp_path), profile_epochs=(1,),
        tensorboard=False, log_fn=lambda s: None), seed=0)
    tr.fit(lambda: _loader(dataset))
    with open(tmp_path / "profile_ep1.json") as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name", "").startswith("dva::"):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert tids["dva::loader.produce"] and tids["dva::step.forward"]
    assert not tids["dva::loader.produce"] & tids["dva::step.forward"]
    assert tids["dva::loader.get"] == tids["dva::step.forward"]
    # the in-memory spans of the epoch, on the loader's thread
    produce = trace.snapshot()["spans"]["loader.produce"]
    assert set(produce["thread"]) == {"BatchLoader"}


# --- the benchmark's readers -------------------------------------------------

def _snap(rows):
    """A snapshot from ``{name: [(id, parent_id, host_ms, cpu_ms,
    device_ms), ...]}``."""
    names = {i: name for name, rs in rows.items() for i, *_ in rs}
    spans = {}
    for name, rs in rows.items():
        s = spans[name] = {f: [] for f in trace.FIELDS}
        for i, parent, host, cpu, dev in rs:
            for f, v in (("id", i), ("parent_id", parent),
                         ("parent", names.get(parent)), ("thread", "t"),
                         ("batch", None), ("start_ms", 0.0),
                         ("host_ms", host), ("cpu_ms", cpu),
                         ("device_ms", dev)):
                s[f].append(v)
    return {"spans": spans, "counters": {}, "segment_launches": {}}


HAND_MADE = _snap({
    "loader.produce": [(1, None, 100.0, 80.0, None),
                       (5, None, 120.0, 60.0, None)],
    "loader.sample": [(2, 1, 30.0, 30.0, None), (3, 1, 20.0, 20.0, None),
                      (6, 5, 40.0, 40.0, None),
                      (9, None, 99.0, 99.0, None)],   # outside a produce
    "loader.collate": [(4, 1, 25.0, 25.0, None), (7, 5, 35.0, 35.0, None)],
    "step.forward": [(10, None, 50.0, 50.0, None),
                     (20, None, 70.0, 70.0, None)],
    "step.backward": [(17, None, 60.0, 60.0, None),
                      (27, None, 80.0, 80.0, None)],
    "step.optimizer": [(18, None, 5.0, 5.0, None),
                       (28, None, 7.0, 7.0, None)],
    "eval.forward": [(30, None, 9.0, 9.0, None)],
    "model.branch": [(11, 10, 9.0, 9.0, 9.0), (21, 20, 9.0, 9.0, 9.0),
                     (31, 30, 9.0, 9.0, 9.0)],
    "branch.tower": [(12, 11, 1.0, 1.0, 3.0), (13, 11, 1.0, 1.0, 4.0),
                     (22, 21, 1.0, 1.0, 5.0),
                     (32, 31, 1.0, 1.0, 100.0)],      # an eval forward's
    "branch.gather": [(14, 11, 1.0, 1.0, 1.0), (23, 21, 1.0, 1.0, 2.0)],
    "branch.atomic_pool": [(15, 11, 1.0, 1.0, 0.5),
                           (24, 21, 1.0, 1.0, None)],
    "branch.view_pool": [(16, 11, 1.0, 1.0, 2.0), (25, 21, 1.0, 1.0, 4.0)],
})
READINGS = {
    "loader_produce_ms": 110.0, "loader_sample_ms": 45.0,
    "collate_ms": 30.0, "loader_cpu_share": 100.0 * 140.0 / 220.0,
    "forward_host_ms": 60.0, "backward_host_ms": 70.0,
    "optimizer_host_ms": 6.0, "tower_fwd_ms": 6.0,
    "pixel_gather_fwd_ms": 1.5, "atomic_pool_fwd_ms": 0.25,
    "view_pool_fwd_ms": 3.0}
METRICS = [f"{n}.{k}" for n in ("loader_produce_ms", "loader_sample_ms",
                                "collate_ms", "loader_cpu_share")
           for k in ("train", "eval")] + [f"{n}.train" for n in (
               "forward_host_ms", "backward_host_ms", "optimizer_host_ms",
               "tower_fwd_ms", "pixel_gather_fwd_ms", "atomic_pool_fwd_ms",
               "view_pool_fwd_ms")]


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "trace_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_benchmark_lists_each_reader_once():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = [m["name"] for m in json.load(f)["per_layer"]]
    assert sorted(set(METRICS) & set(per_layer)) == sorted(METRICS)
    assert len(METRICS) == 15


@pytest.mark.parametrize("name", METRICS)
def test_reader_of_the_tracer(name, monkeypatch):
    read = _reader(name).read
    empty = {"spans": {}, "counters": {}, "segment_launches": {}}
    monkeypatch.setattr(trace, "snapshot", lambda: empty)
    assert read(None) is None
    monkeypatch.setattr(trace, "snapshot", lambda: HAND_MADE)
    assert read(None) == pytest.approx(READINGS[name.split(".")[0]])
    # a program without the tracer (the parent of this change)
    monkeypatch.setitem(sys.modules, "deepviewagg_tpu_torch.utils.trace",
                        None)
    assert read(None) is None
