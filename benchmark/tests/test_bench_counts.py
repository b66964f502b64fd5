"""The yardstick's FLOP and byte counts against hand counts."""

import torch

from benchmark.harness import counts
from benchmark.reference.graph import build_graph


def test_sparse_pairs_and_flops_of_a_line_of_voxels():
    # three voxels in a row at level 0: each has itself and its neighbours
    coords = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]])
    g = build_graph(coords, 2)
    sub, down = g.pair_counts()
    # level 1 holds z = 0 and z = 2, neighbours at stride 2
    assert [c.shape[0] for c in g.coords] == [3, 2]
    assert sub == [3 + 2 + 2, 2 + 2]
    assert down == [3]                     # each fine voxel to its parent


def test_tower_flops_by_hand():
    shapes = {"t.Conv2dWS_0.weight": (4, 3, 3, 3),
              "t._BasicBlock2d_0.Conv2dWS_0.weight": (8, 4, 3, 3),
              "t._BasicBlock2d_0.Conv2dWS_1.weight": (8, 8, 3, 3),
              "t._BasicBlock2d_0.Conv2dWS_2.weight": (8, 4, 1, 1)}
    f, (w, h) = counts._tower_flops(shapes, "t", 2, 32, 16)
    # stem: 16 x 8 outputs; pool: 8 x 4; the block at stride 1
    stem = 2 * 2 * 16 * 8 * 4 * 3 * 9
    block = 2 * 2 * 8 * 4 * (8 * 4 * 9 + 8 * 8 * 9 + 8 * 4)
    assert (w, h) == (8, 4) and f == stem + block


def test_segment_bytes_by_hand():
    x = torch.zeros(10, 4)
    ptr = torch.tensor([0, 3, 3, 8], dtype=torch.int32)   # rows 8, 9 outside
    valid = torch.ones(10, dtype=torch.bool)
    valid[1] = False
    live = 7                                             # rows 0, 2-7
    want = live * 4 * 4 + 10 + 4 * 4 + 3 * 4 * 4
    assert float(counts.segment_fwd_bytes(x, ptr, valid)) == want
    g = torch.zeros(3, 4)
    # two segments hold a live row; max also reads x's live rows and out
    want_b = 2 * 4 * 4 + 10 + 4 * 4 + 10 * 4 * 4
    assert float(counts.segment_bwd_bytes(g, x, ptr, valid, "sum", 10)) \
        == want_b
    assert float(counts.segment_bwd_bytes(g, x, ptr, valid, "max", 10)) \
        == want_b + live * 4 * 4 + 2 * 4 * 4
    assert float(counts.segment_fwd_bytes(x, ptr, None)) == \
        8 * 16 + 16 + 48


def test_peaks_of_the_h100():
    p = counts.peak_for("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
