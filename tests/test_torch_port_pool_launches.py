"""Each distinct sorted-segment reduction of the view pool is taken once.

``GroupViewPool`` hands the compatibilities' per-segment maximum (detached)
and the per-segment view count to ``segment_softmax`` instead of letting it
recompute them; ``UnimodalBranch`` counts the views once for the pool and for
``x_seen``.  Outputs, attention and every gradient must be bit-identical to
the path that recomputes them, and a flagship-shaped branch must make six
forward and five backward ``segment_csr`` calls.
"""

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.modules import branch as tbranch
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import pooling as tpool
from deepviewagg_tpu_torch.ops import segment as tseg
from torch_port_util import (_torch_threads, jax_tiny_batch,  # noqa: F401
                             segment_case, torch_batch)


def _pool_inputs(seed=0, e=600, s=90):
    _, ids, valid, ptr, s = segment_case(seed, e=e, s=s)
    rng = np.random.default_rng(seed + 1)
    x_mod = rng.normal(size=(e, 12)).astype(np.float32)
    x_map = rng.normal(size=(e, 8)).astype(np.float32)
    t = torch.from_numpy
    return t(x_mod), t(x_map), t(ids), t(valid), t(ptr), s


def _run(pool, x_mod, x_map, ids, valid, ptr, s):
    x_mod = x_mod.clone().requires_grad_()
    x_map = x_map.clone().requires_grad_()
    pool.zero_grad(set_to_none=True)
    pooled, attn = pool(x_mod, x_map, ids, valid, s, ptr=ptr)
    g = torch.Generator().manual_seed(5)
    loss = ((pooled * torch.randn(pooled.shape, generator=g)).sum()
            + (attn * torch.randn(attn.shape, generator=g)).sum())
    loss.backward()
    grads = {k: p.grad.clone() for k, p in pool.named_parameters()}
    grads["x_mod"], grads["x_map"] = x_mod.grad, x_map.grad
    return pooled.detach(), attn.detach(), grads


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_merged_reductions_are_bit_identical(monkeypatch, scaling, gated):
    torch.manual_seed(0)
    pool = tpool.GroupViewPool(12, 16, num_groups=4, set_channels=8,
                               scaling=scaling, gated=gated).train()
    inputs = _pool_inputs()
    got = _run(pool, *inputs)
    assert all(g is not None for g in got[2].values())

    # the reference: every module recomputes its own maximum and count
    softmax = tseg.segment_softmax

    def unmerged_softmax(*args, seg_max=None, count=None, **kwargs):
        return softmax(*args, **kwargs)

    set_enc = tpool.DeepSetFeat.forward

    def unmerged_set_enc(self, *args, count=None, **kwargs):
        return set_enc(self, *args, **kwargs)

    monkeypatch.setattr(tseg, "segment_softmax", unmerged_softmax)
    monkeypatch.setattr(tpool.DeepSetFeat, "forward", unmerged_set_enc)
    ref = _run(pool, *inputs)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[2].keys() == ref[2].keys()
    for k in ref[2]:
        assert torch.equal(got[2][k], ref[2][k]), k


@pytest.mark.parametrize("scaling", [False, True])
def test_pool_takes_the_callers_count(scaling):
    torch.manual_seed(1)
    pool = tpool.GroupViewPool(12, 16, num_groups=2, set_channels=8,
                               scaling=scaling).eval()
    x_mod, x_map, ids, valid, ptr, s = _pool_inputs(3)
    count = tseg.segment_count(ids, s, valid, ptr)
    with torch.no_grad():
        ref = pool(x_mod, x_map, ids, valid, s, ptr=ptr)
        got = pool(x_mod, x_map, ids, valid, s, ptr=ptr, count=count)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _count_calls(monkeypatch):
    calls = {"forward": [], "backward": []}
    fwd, bwd = tseg.segment_csr, tseg.segment_csr_bwd

    def forward(x, ptr, valid, reduce):
        calls["forward"].append((tuple(x.shape), reduce))
        return fwd(x, ptr, valid, reduce)

    def backward(g, x, out, ptr, valid, reduce, num_rows=None):
        calls["backward"].append((tuple(g.shape), reduce))
        return bwd(g, x, out, ptr, valid, reduce, num_rows)

    monkeypatch.setattr(tseg, "segment_csr", forward)
    monkeypatch.setattr(tseg, "segment_csr_bwd", backward)
    return calls


def test_flagship_shaped_branch_makes_six_forward_and_five_backward_calls(
        monkeypatch):
    """The flagship's branch options (max atomic pool, 4-group gated pool
    with scaling and the size feature, concat fusion) at a small width."""
    batch, _ = jax_tiny_batch()
    tb = torch_batch(batch)
    m = tb["mappings"][0]
    # the merged count is the same function of the same rows: collate's
    # pointer is the one a searchsorted of the ids gives
    n_seg = tb["feats"].shape[0] + 1
    assert torch.equal(tseg.segment_ptr(m["point_id"], n_seg),
                       m["point_ptr"].to(torch.int32))
    torch.manual_seed(2)
    branch = tbranch.UnimodalBranch(
        tt.ResNet18(out_level=1), 64, tb["feats"].shape[1], 32, num_groups=4,
        tower_bf16=False, fusion_mode="concatenation").train()
    ref_size = tuple(tb["images"].shape[1:3])
    calls = _count_calls(monkeypatch)
    out, seen = branch(tb["feats"], tb["images"], m, ref_size)
    assert [r for _, r in calls["forward"]] == [
        "max", "sum", "max", "max", "sum", "sum"]
    widths = [shape[1] for shape, _ in calls["forward"]]
    assert widths == [64, 1, 32, 4, 4, 32]
    assert not calls["backward"]
    out.square().sum().backward()
    assert len(calls["backward"]) == 5
    assert sorted(r for _, r in calls["backward"]) == [
        "max", "max", "max", "sum", "sum"]
    assert seen.any()

    # eval, no gradient: the same six calls, none of them backward
    calls["forward"].clear()
    calls["backward"].clear()
    with torch.no_grad():
        branch.eval()(tb["feats"], tb["images"], m, ref_size)
    assert len(calls["forward"]) == 6 and not calls["backward"]


def test_x_seen_is_the_count_the_pool_used(monkeypatch):
    batch, _ = jax_tiny_batch()
    tb = torch_batch(batch)
    m = tb["mappings"][0]
    torch.manual_seed(3)
    branch = tbranch.UnimodalBranch(
        tt.ResNet18(out_level=1), 64, tb["feats"].shape[1], 32, num_groups=4,
        tower_bf16=False).eval()
    with torch.no_grad():
        _, seen = branch(tb["feats"], tb["images"], m,
                         tuple(tb["images"].shape[1:3]))
    n = tb["feats"].shape[0]
    # the count as the branch took it before: from the ids alone
    ref = tseg.segment_count(m["point_id"], n + 1, m["view_valid"])[:n] > 0
    assert torch.equal(seen, ref)
