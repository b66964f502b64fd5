"""The reduction of a device trace: busy time, families, and the idle time
split by the host span that held it."""

import pytest

from benchmark.harness.trace import reduce_trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_time_goes_to_the_innermost_host_span_over_it():
    events = [
        _x("user_annotation", "bench::window", 0, 100),
        _x("user_annotation", "bench::step", 0, 40),
        _x("user_annotation", "bench::forward", 0, 20),
        _x("user_annotation", "bench::loader_wait", 40, 50),
        _x("kernel", "segment_csr_tile_kernel", 5, 10),
        _x("kernel", "segment_csr_finish_kernel", 12, 6),
        _x("kernel", "ampere_sgemm", 25, 10),
        _x("kernel", "segment_csr_bwd_kernel", 95, 10),   # past the window
        _x("cpu_op", "aten::mm", 0, 5),
    ]
    out = reduce_trace(events)
    assert out["window_s"] == pytest.approx(100e-6)
    # busy: [5, 18) and [25, 35) and [95, 100)
    assert out["busy_s"] == pytest.approx(28e-6)
    idle = dict(out["idle_gaps"])
    # forward [0, 20): idle 0-5 and 18-20; step 20-25 and 35-40;
    # loader_wait 40-90; nothing 90-95
    assert idle == pytest.approx({"forward": 7e-6, "step": 10e-6,
                                  "loader_wait": 50e-6,
                                  "other_host": 5e-6})
    assert out["segment_fwd_s"] == pytest.approx(13e-6)
    assert out["segment_bwd_s"] == pytest.approx(5e-6)
    fams = dict(out["device_ops"])
    assert fams["matmul"] == pytest.approx(10e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        reduce_trace([_x("kernel", "k", 0, 1)])


def test_segment_bytes_are_counted_after_the_window_per_distinct_batch():
    """Each distinct batch runs once more under the probe; its bytes count
    as many times as the window ran it."""
    import types

    import torch

    from benchmark.harness.counts import segment_fwd_bytes
    from benchmark.harness.trace import window_segment_bytes

    def fwd(x, ptr, valid, reduce):
        return x[:ptr.numel() - 1]

    def bwd(g, x, out, ptr, valid, reduce, num_rows=None):
        return torch.zeros(num_rows, g.shape[1])

    seg = types.SimpleNamespace(_segment_csr_forward=fwd,
                                segment_csr_bwd=bwd)
    sizes = {"a": 6, "b": 10}
    ran = []

    def step(batch):
        ran.append(batch)
        x = torch.ones(sizes[batch], 3)
        ptr = torch.tensor([0, 2, sizes[batch]])
        seg._segment_csr_forward(x, ptr, None, "sum")

    f, b = window_segment_bytes(seg, ["a", "b", "a"], step)
    one = {k: float(segment_fwd_bytes(torch.ones(n, 3),
                                      torch.tensor([0, 2, n]), None))
           for k, n in sizes.items()}
    assert ran == ["a", "b"]
    assert f == pytest.approx(2 * one["a"] + one["b"]) and b == 0.0
    assert seg._segment_csr_forward is fwd and seg.segment_csr_bwd is bwd
