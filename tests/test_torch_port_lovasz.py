"""The Lovász-softmax's class-major scan (``ops/lovasz.py``,
``csrc/lovasz.cu``) and the loss built on it (``models/losses.py``).

The reference of this file is the row-major formula: ``lovasz_grad`` along
dim 0 of the ``[N, C]`` errors sorted per column, one column a class
(:func:`_row_major_lovasz`).  On the CPU: the plain model of the kernel's
tiles (``lovasz_scan_tiled_plain``) gives its weights bit for bit on inputs
that exercise the tile edges, and the loss gives the row-major loss and
logit gradient.  On the card (marker ``card``; they skip without CUDA): the
kernel's weights bit for bit, its products within 1e-6 relative, the
logits' gradient against the row-major formula's autograd, and one launch a
call.  The file imports no JAX, so that the card's machine runs it as it
is::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_lovasz.py -q -m card
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.models import losses as tl
from deepviewagg_tpu_torch.ops import lovasz as lv
from deepviewagg_tpu_torch.utils import trace
from torch_port_util import card  # noqa: F401

T = lv.TILE_ROWS
_TOL = 1e-6
# the PTv3 cell's level 0: 12 crops of 102,400 points, 13 classes
CELL_ROWS, CELL_CLASSES = 1_228_800, 13


def _sorted_case(n, fg_rows, seed, levels=None):
    """``(err_s [C, N] float32, fg_s [C, N] uint8)``: one row per entry of
    ``fg_rows`` (a probability of foreground, or a bool array), the errors
    sorted descending per row; ``levels`` quantises them into ties."""
    rng = np.random.default_rng(seed)
    err = rng.random((len(fg_rows), n)).astype(np.float32)
    if levels:
        err = np.floor(err * levels).astype(np.float32) / levels
    fg = np.stack([np.asarray(f, bool) if not np.isscalar(f)
                   else rng.random(n) < f for f in fg_rows])
    err_s = -np.sort(-err, axis=1, kind="stable")
    return torch.from_numpy(err_s), torch.from_numpy(fg.astype(np.uint8))


def _runs_across_edges(n):
    """Foreground runs that start before a tile edge and end after it."""
    fg = np.zeros(n, bool)
    for edge in range(T, n, T):
        fg[edge - 5:edge + 3] = True
    fg[2 * T - 1:2 * T + 200] = True
    return fg


def edge_cases():
    """``[(name, err_s, fg_s)]``: every edge of a scan tiled by ``T``
    rows."""
    dead = lambda n: np.zeros(n, bool)        # noqa: E731
    live = lambda n: np.ones(n, bool)         # noqa: E731
    cases = [
        ("n1", *_sorted_case(1, [1.0, 0.0, 0.5], 0)),
        ("tile_minus_1", *_sorted_case(T - 1, [0.3, 0.9, 0.02], 1)),
        ("tile", *_sorted_case(T, [0.3, 0.5, 0.98], 2)),
        ("tile_plus_1", *_sorted_case(T + 1, [0.3, 0.1, 0.7], 3)),
        ("runs_across_edges",
         *_sorted_case(3 * T + 7, [_runs_across_edges(3 * T + 7), 0.4], 4)),
        ("absent_and_all_foreground",
         *_sorted_case(2 * T + 9, [dead(2 * T + 9), live(2 * T + 9), 0.5],
                       5)),
        ("ties", *_sorted_case(2 * T + 3, [0.3, 0.6], 6, levels=4)),
        ("no_rows", torch.zeros((3, 0)),
         torch.zeros((3, 0), dtype=torch.uint8)),
    ]
    # every row masked: errors exactly 0, no foreground
    n = T + 17
    cases.append(("all_masked", torch.zeros((2, n)),
                  torch.zeros((2, n), dtype=torch.uint8)))
    return cases


CASES = edge_cases()
IDS = [c[0] for c in CASES]


def _plain_grad(fg_s):
    """The row-major ``lovasz_grad`` (along dim 0 of ``[N, C]``) of each
    class's row."""
    return lv.lovasz_grad(fg_s.t().to(torch.float32)).t()


def _row_major_lovasz(logits, labels, valid=None):
    """The Lovász-softmax by the row-major formula: the ``[N, C]`` errors
    sorted per column (stable), ``lovasz_grad`` along dim 0, the mean over
    the classes present."""
    mask = labels != tl.IGNORE_LABEL
    if valid is not None:
        mask = mask & valid
    probs = torch.softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    fg = ((labels[:, None] == classes) & mask[:, None]).to(torch.float32)
    err = torch.where(mask[:, None], torch.abs(fg - probs), 0.0)
    err_s, order = torch.sort(err, dim=0, descending=True, stable=True)
    loss_c = torch.sum(err_s * lv.lovasz_grad(torch.gather(fg, 0, order)),
                       dim=0)
    present = torch.sum(fg, dim=0) > 0
    return torch.sum(torch.where(present, loss_c, 0.0)) / torch.clamp(
        torch.sum(present.to(torch.float32)), min=1.0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) \
        if b.numel() else 0.0


@pytest.mark.parametrize("tile_rows", [T, 7])
@pytest.mark.parametrize("name,err_s,fg_s", CASES, ids=IDS)
def test_tiled_model_gives_the_plain_weights_bit_for_bit(name, err_s, fg_s,
                                                          tile_rows):
    ref = _plain_grad(fg_s)
    w, loss = lv.lovasz_scan_tiled_plain(err_s, fg_s, tile_rows)
    assert torch.equal(w, ref), name
    plain_w, plain_loss = lv.lovasz_scan_plain(err_s, fg_s)
    assert torch.equal(plain_w, ref), name
    assert _rel(loss, plain_loss) <= _TOL, (loss, plain_loss)


def test_the_cases_reach_every_tile_edge():
    names = {name: (err, fg) for name, err, fg in CASES}
    assert {names[k][0].shape[1] for k in
            ("tile_minus_1", "tile", "tile_plus_1")} == {T - 1, T, T + 1}
    fg = names["runs_across_edges"][1][0].numpy().astype(bool)
    assert fg[T - 1] and fg[T] and fg[2 * T - 1] and fg[2 * T]
    err = names["ties"][0]
    assert len(torch.unique(err)) <= 5
    assert not names["absent_and_all_foreground"][1][0].any()
    assert names["absent_and_all_foreground"][1][1].all()


def test_lovasz_scan_takes_the_plain_version_on_the_cpu():
    _, err_s, fg_s = CASES[4]
    before = dict(lv.LAUNCHES)
    w, loss = lv.lovasz_scan(err_s, fg_s)
    assert torch.equal(w, _plain_grad(fg_s))
    assert lv.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "fg_dtype", "shape", "ndim"])
def test_lovasz_scan_refuses_what_the_kernel_does_not_take(bad):
    err, fg = torch.zeros((2, 5)), torch.zeros((2, 5), dtype=torch.uint8)
    args = {"dtype": (err.double(), fg), "fg_dtype": (err, fg.bool()),
            "shape": (err, fg[:, :4]), "ndim": (err[0], fg[0])}[bad]
    with pytest.raises((TypeError, ValueError)):
        lv.lovasz_scan(*args)


def test_lovasz_dot_gradient_is_the_weights_times_the_cotangent():
    _, err_s, fg_s = CASES[5]
    g = torch.tensor([0.5, -2.0, 3.0])
    x = err_s.clone().requires_grad_()
    (lv.lovasz_dot(x, fg_s) * g).sum().backward()
    y = err_s.clone().requires_grad_()
    (torch.sum(y * _plain_grad(fg_s), dim=1) * g).sum().backward()
    assert torch.equal(x.grad, y.grad)


def _logits_case(n=3000, c=6, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, c)) * 2.0).astype(np.float32)
    labels = rng.integers(0, c - 1, n).astype(np.int64)   # class c-1 absent
    labels[rng.random(n) < 0.1] = -1
    # ties: a block of rows with one logit vector and one label
    logits[100:400] = logits[100]
    labels[100:400] = 2
    valid = rng.random(n) > 0.2
    return (torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(valid))


def _loss_and_grad(fn, logits, labels, valid):
    x = logits.clone().requires_grad_()
    loss = fn(x, labels, valid)
    loss.backward()
    return float(loss.detach()), x.grad


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_class_major_loss_matches_the_plain_path_on_the_cpu(masked):
    logits, labels, valid = _logits_case()
    valid = {"some": valid, "none": None,
             "all": torch.zeros_like(valid)}[masked]
    ref, ref_g = _loss_and_grad(_row_major_lovasz, logits, labels, valid)
    got, got_g = _loss_and_grad(tl.lovasz_softmax, logits, labels, valid)
    assert abs(got - ref) <= _TOL * max(abs(ref), 1.0), (got, ref)
    assert float((got_g - ref_g).norm()) <= _TOL * max(
        float(ref_g.norm()), 1e-30)


def _traced(fn):
    """``fn()``'s spans kept under a profiler."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    spans = trace.snapshot()["spans"]
    trace.reset()
    return spans


def test_a_cpu_call_counts_one_plain_lovasz_and_its_span():
    """On the CPU: one ``loss.lovasz`` span a call, no kernel launch, and
    no span at weight 0."""
    logits, labels, valid = _logits_case(n=200)
    before = dict(lv.LAUNCHES)
    spans = _traced(lambda: [
        tl.segmentation_loss(logits, labels, valid, lovasz_weight=1.0)
        for _ in range(3)])
    assert len(spans["loss.lovasz"]["id"]) == 3
    assert lv.LAUNCHES == before
    # the recipes' weight 0 never calls it
    spans = _traced(lambda: tl.segmentation_loss(
        logits, labels, valid, lovasz_weight=0.0))
    assert "loss.lovasz" not in spans


# --- on the card ------------------------------------------------------------


def _cell_case(device, seed=0):
    """Sorted errors and foreground at the PTv3 cell's shape."""
    g = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, CELL_CLASSES, (CELL_ROWS,), generator=g,
                           device=device)
    fg = (labels[None, :] == torch.arange(CELL_CLASSES, device=device)[:, None])
    err = torch.rand((CELL_CLASSES, CELL_ROWS), generator=g, device=device)
    err = torch.where(torch.rand(err.shape, generator=g, device=device) < 0.1,
                      0.0, err)                       # masked rows, ties
    err_s, order = torch.sort(err, dim=1, descending=True, stable=True)
    return err_s, torch.gather(fg.to(torch.uint8), 1, order)


@pytest.mark.card
def test_card_weights_bit_equal_at_the_cells_shape(card):
    err_s, fg_s = _cell_case(card)
    before = lv.LAUNCHES["lovasz"]
    w, loss = lv.lovasz_scan(err_s, fg_s)
    torch.cuda.synchronize()
    assert lv.LAUNCHES["lovasz"] == before + 1
    ref_w, ref_loss = lv.lovasz_scan_plain(err_s, fg_s)
    assert torch.equal(w, ref_w)
    assert torch.equal(w, _plain_grad(fg_s))
    assert _rel(loss, ref_loss) <= _TOL, (loss, ref_loss)
    w2, loss2 = lv.lovasz_scan(err_s, fg_s)
    assert torch.equal(w, w2) and torch.equal(loss, loss2)   # deterministic


@pytest.mark.card
@pytest.mark.parametrize("name,err_s,fg_s", CASES, ids=IDS)
def test_card_weights_bit_equal_on_the_edge_cases(card, name, err_s, fg_s):
    w, loss = lv.lovasz_scan(err_s.to(card), fg_s.to(card))
    assert torch.equal(w.cpu(), _plain_grad(fg_s)), name
    _, tiled = lv.lovasz_scan_tiled_plain(err_s, fg_s)
    assert _rel(loss.cpu(), tiled) <= _TOL, (loss, tiled)


@pytest.mark.card
def test_card_logit_gradient_matches_the_plain_autograd(card):
    g = torch.Generator(device=card).manual_seed(1)
    logits = torch.randn((CELL_ROWS, CELL_CLASSES), generator=g,
                         device=card) * 2.0
    labels = torch.randint(-1, CELL_CLASSES - 1, (CELL_ROWS,), generator=g,
                           device=card)               # one class absent
    valid = torch.rand(CELL_ROWS, generator=g, device=card) > 0.05
    ref, ref_g = _loss_and_grad(_row_major_lovasz, logits, labels, valid)
    before = lv.LAUNCHES["lovasz"]
    got, got_g = _loss_and_grad(tl.lovasz_softmax, logits, labels, valid)
    assert lv.LAUNCHES["lovasz"] == before + 1
    assert abs(got - ref) <= _TOL * abs(ref), (got, ref)
    assert float((got_g - ref_g).norm() / ref_g.norm()) <= _TOL


@pytest.mark.card
def test_card_call_counts_one_kernel_lovasz_and_one_launch(card):
    """On the card: one kernel launch and one ``loss.lovasz`` span with
    device time a call."""
    logits, labels, valid = (t.to(card) for t in _logits_case(n=5000))
    before = lv.LAUNCHES["lovasz"]
    spans = _traced(lambda: [
        tl.segmentation_loss(logits, labels, valid, lovasz_weight=1.0)
        for _ in range(2)])
    assert lv.LAUNCHES["lovasz"] == before + 2
    assert len(spans["loss.lovasz"]["id"]) == 2
    assert all(ms is not None and ms > 0
               for ms in spans["loss.lovasz"]["device_ms"])
