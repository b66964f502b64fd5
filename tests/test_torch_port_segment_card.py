"""The sorted-segment kernels on the card (``csrc/segment_csr.cu`` and
``csrc/segment_csr_bwd.cu``, through ``ops/segment.py``) against their plain
versions (marker ``card``; they skip without CUDA).

Forward: max bit for bit, sum within ``SUM_RTOL`` (only the summation order
differs), the same bits on two runs.  Backward: bit for bit.  The calls
are those of the flagship model (Res16UNet34 + ResNet18-PPM branch, random
weights from a seed) on the benchmark request: its forward's six calls, no
two of them the same reduction, and its train step's five backward calls;
then empty, masked and all-masked segments, forced ties (every
max-attaining row gets the full cotangent) and the tile-edge inputs of
``ops/segment.py::segment_edge_cases``.  The file imports no JAX, so that
the card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_segment_card.py -q -m card
"""

import pytest
import torch

from deepviewagg_tpu_torch.data.collate import batch_to_torch
from deepviewagg_tpu_torch.data.toy import flagship_spec, toy_batch
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
from deepviewagg_tpu_torch.ops import segment as seg
from torch_port_util import (BACKWARD_LAUNCHES, FORWARD_LAUNCHES,  # noqa: F401
                             SERVE_REQUEST, card, check_bwd_call, check_call,
                             record_backward_calls, record_segment_calls)

MASKED_WIDTHS = (1, 3, 4, 64)
EDGE_WIDTHS = (1, 3, 4, 5, 32, 64, 128, 130)
BACKWARD_EDGE_WIDTHS = (1, 4, 128)


def _flagship(device, train: bool):
    model = MultimodalSeg(flagship_spec(), device=device, seed=0)
    np_batch, _, _ = toy_batch(seed=0, device=device, **SERVE_REQUEST)
    return model.train(train), batch_to_torch(np_batch, device=device)


def _same_call(a, b) -> bool:
    return a[3] == b[3] and all(
        (u is None) == (v is None) and (u is None or (
            u.shape == v.shape and torch.equal(u, v)))
        for u, v in zip(a[:3], b[:3]))


@pytest.mark.card
def test_card_flagship_forward_calls_match_the_plain_version(card):
    calls = record_segment_calls(*_flagship(card, train=False))
    assert len(calls) == FORWARD_LAUNCHES
    for i, a in enumerate(calls):
        for j in range(i):
            assert not _same_call(a, calls[j]), (j, i)
    for call in calls:
        check_call(*call)


@pytest.mark.card
def test_card_flagship_backward_calls_are_bit_equal_to_the_plain_version(
        card):
    calls = record_backward_calls(*_flagship(card, train=True))
    assert len(calls) == BACKWARD_LAUNCHES
    for call in calls:
        check_bwd_call(*call)


def _masked_case(device, seed):
    """5,000 sorted rows in 900 segments (the upper half empty), 30% of the
    rows masked and every segment whose id is 1 mod 5 all-masked."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e, s = 5000, 900
    ids = torch.sort(torch.randint(0, s // 2, (e,), generator=gen,
                                   device=device))[0]
    valid = (torch.rand(e, generator=gen, device=device) > 0.3) \
        & (ids % 5 != 1)
    return gen, ids, valid, seg.segment_ptr(ids.to(torch.int32), s)


@pytest.mark.card
@pytest.mark.parametrize("c", MASKED_WIDTHS)
def test_card_forward_empty_masked_and_all_masked_segments(card, c):
    gen, ids, valid, ptr = _masked_case(card, 0)
    x = torch.randn(ids.shape[0], c, generator=gen, device=card)
    for reduce in ("sum", "max"):
        for v in (None, valid):
            check_call(x, ptr, v, reduce)
            out = seg.segment_csr(x, ptr, v, reduce)
            counts = ptr[1:] - ptr[:-1]
            if v is not None:
                counts = seg.segment_csr_plain(
                    v[:, None].float(), ptr, None, "sum")[:, 0]
            assert out[counts == 0].abs().sum() == 0, \
                "empty or all-masked segment not 0"


@pytest.mark.card
@pytest.mark.parametrize("c", EDGE_WIDTHS)
def test_card_forward_tile_edges(card, c):
    tile = seg.kernel_tile_rows(c)
    for name, x, ptr, v in seg.segment_edge_cases(tile, c):
        x, ptr = x.to(card), ptr.to(card)
        v = None if v is None else v.to(card)
        for reduce in ("sum", "max"):
            try:
                check_call(x, ptr, v, reduce)
            except AssertionError as exc:
                raise AssertionError(f"edge case {name}, width {c}, tile "
                                     f"{tile}, {reduce}: {exc}") from exc


@pytest.mark.card
@pytest.mark.parametrize("c", MASKED_WIDTHS)
def test_card_backward_masked_segments_and_ties(card, c):
    """Both tied rows get the full cotangent, rows of an all-masked segment
    get none."""
    gen, ids, valid, ptr = _masked_case(card, 1)
    e, s = ids.shape[0], ptr.numel() - 1
    x = torch.randn(e, c, generator=gen, device=card)
    # tie: copy each row onto its successor where both share a segment
    same = torch.zeros(e, dtype=torch.bool, device=card)
    same[1::2] = ids[1::2] == ids[0:-1:2]
    x[same] = x[torch.nonzero(same)[:, 0] - 1]
    g = torch.randn(s, c, generator=gen, device=card)
    for v in (None, valid):
        for reduce in ("sum", "max"):
            out = seg.segment_csr(x, ptr, v, reduce)
            check_bwd_call(g, x, out, ptr, v, reduce, e)
        out = seg.segment_csr(x, ptr, v, "max")
        gx = seg.segment_csr_bwd(g, x, out, ptr, v, "max")
        keep = torch.ones_like(valid) if v is None else v
        hit = keep[:, None] & (x == out[ids])
        assert torch.equal(gx[hit], g[ids][hit]), \
            "a max-attaining row lacks the full cotangent"
        tied = same & keep & torch.roll(keep, 1)
        both = tied[:, None] & hit
        assert both.any() and torch.equal(
            gx[both], torch.roll(gx, 1, 0)[both]), \
            "tied rows did not both get the cotangent"
        if v is not None:
            dead = ~valid | (ids % 5 == 1)
            assert gx[dead].abs().sum() == 0, \
                "masked or all-masked rows got gradient"


@pytest.mark.card
@pytest.mark.parametrize("c", BACKWARD_EDGE_WIDTHS)
def test_card_backward_tile_edges(card, c):
    """The forward's tile-edge inputs (a crop-ladder bucket's all-empty and
    interleaved-empty calls among them), with a random cotangent."""
    gen = torch.Generator(device=card).manual_seed(1)
    for name, x, ptr, v in seg.segment_edge_cases(seg.kernel_tile_rows(c),
                                                  c):
        x, ptr = x.to(card), ptr.to(card)
        v = None if v is None else v.to(card)
        g = torch.randn(ptr.numel() - 1, c, generator=gen, device=card)
        for reduce in ("sum", "max"):
            out = seg.segment_csr(x, ptr, v, reduce)
            try:
                check_bwd_call(g, x, out, ptr, v, reduce, x.shape[0])
            except AssertionError as exc:
                raise AssertionError(f"edge case {name}, width {c}, "
                                     f"{reduce}: {exc}") from exc


@pytest.mark.card
def test_card_backward_takes_strided_x_and_out(card):
    """Strided ``x`` and ``out`` of one size: the wrapper copies both, and
    each copy must live until the kernel reads it (a copy freed before the
    launch hands its block to the next one)."""
    gen = torch.Generator(device=card).manual_seed(2)
    e = c = 64                                  # E rows in S = E segments
    ids = torch.sort(torch.randint(0, e, (e,), generator=gen,
                                   device=card))[0]
    ptr = seg.segment_ptr(ids.to(torch.int32), e)
    x = torch.randn(c, e, generator=gen, device=card).t()
    out = seg.segment_csr(x.contiguous(), ptr, None, "max").t().contiguous().t()
    g = torch.randn(e, c, generator=gen, device=card)
    assert not (x.is_contiguous() or out.is_contiguous())
    check_bwd_call(g, x, out, ptr, None, "max", e)
