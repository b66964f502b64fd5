"""The port's schedules and optimizer against optax, as the JAX package's
``make_schedule`` / ``make_optimizer`` build them: every schedule at a list
of steps, and three consecutive updates of sgd / adam / adamw on the same
numpy gradients with clipping active and inactive, ``lr_scales`` and
``freeze_paths``.  The arithmetic is the same in float32 (the port evaluates
schedules in Python floats): 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from deepviewagg_tpu.train import optimizers as jopt
from deepviewagg_tpu_torch.train import optimizers as topt
from torch_port_util import _torch_threads, flat_leaves, rel_err  # noqa: F401

_TOL = 1e-6
_STEPS = [0, 1, 2, 9, 10, 11, 49, 50, 51, 99, 100, 101, 250, 1000]

_SCHEDULES = {
    "multi_step": dict(kind="multi_step", base_lr=0.1, milestones=(10, 50, 100),
                       gamma=0.3),
    "poly": dict(kind="poly", base_lr=0.05, total_steps=100, power=0.9),
    "cosine": dict(kind="cosine", base_lr=0.2, total_steps=100),
    "exponential": dict(kind="exponential", base_lr=0.1, total_steps=300,
                        gamma=0.3),
    "constant": dict(kind="constant", base_lr=0.1),
    "warm_multi_step": dict(kind="multi_step", base_lr=0.1, milestones=(40,),
                            gamma=0.1, warmup_steps=10),
    "warm_cosine": dict(kind="cosine", base_lr=0.1, total_steps=90,
                        warmup_steps=10),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedules_match_optax(name):
    ref_fn = jopt.make_schedule(**_SCHEDULES[name])
    got_fn = topt.make_schedule(**_SCHEDULES[name])
    for step in _STEPS:
        ref = float(ref_fn(jnp.asarray(step, jnp.int32)))
        got = float(got_fn(step))
        assert abs(got - ref) <= _TOL * 0.2, (name, step, got, ref)


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError):
        topt.make_schedule("nope")
    with pytest.raises(ValueError):
        topt.make_optimizer(topt.make_schedule("constant"), optimizer="nope")


class _Net(nn.Module):
    """Parameters under flax-like names: two top-level groups, one nested."""

    def __init__(self, values):
        super().__init__()
        self.tower = nn.Module()
        self.tower.conv = nn.Module()
        self.tower.conv.weight = nn.Parameter(torch.from_numpy(values["tower"]["conv"]["weight"].copy()))
        self.tower.scale = nn.Parameter(torch.from_numpy(values["tower"]["scale"].copy()))
        self.head = nn.Module()
        self.head.weight = nn.Parameter(torch.from_numpy(values["head"]["weight"].copy()))
        self.head.bias = nn.Parameter(torch.from_numpy(values["head"]["bias"].copy()))


def _tree(rng, scale):
    return {
        "tower": {"conv": {"weight": (rng.normal(size=(5, 7)) * scale).astype(np.float32)},
                  "scale": (rng.normal(size=(7,)) * scale).astype(np.float32)},
        "head": {"weight": (rng.normal(size=(7, 3)) * scale).astype(np.float32),
                 "bias": (rng.normal(size=(3,)) * scale).astype(np.float32)},
    }


def _torch_tree(net):
    return {
        "tower": {"conv": {"weight": net.tower.conv.weight},
                  "scale": net.tower.scale},
        "head": {"weight": net.head.weight, "bias": net.head.bias},
    }


_GROUPS = {
    "plain": {},
    "lr_scales": dict(lr_scales={"tower": 0.1}),
    "frozen": dict(freeze_paths=[("tower", "conv")]),
    "both": dict(lr_scales={"head": 3.0}, freeze_paths=[("tower", "scale")]),
}


@pytest.mark.parametrize("groups", sorted(_GROUPS))
@pytest.mark.parametrize("grad_scale", [0.05, 30.0],
                         ids=["clip_inactive", "clip_active"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
def test_three_updates_match_optax(optimizer, grad_scale, groups):
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    kw = dict(optimizer=optimizer, momentum=0.9, weight_decay=1e-2,
              grad_clip=1.0, **_GROUPS[groups])
    sched = dict(kind="multi_step", base_lr=0.1, milestones=(1, 2), gamma=0.5)

    # whether the clip triggers, per group when there are several
    norm = np.sqrt(sum((g ** 2).sum() for g in flat_leaves(grads[0]).values()))
    assert (norm > 1.0) == (grad_scale > 1.0)

    tx = jopt.make_optimizer(jopt.make_schedule(**sched), **kw)
    ref = params
    opt_state = tx.init(ref)
    net = _Net(params)
    opt = topt.make_optimizer(topt.make_schedule(**sched), **kw).init(
        net.named_parameters())
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(g, opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        for name, p in flat_leaves(_torch_tree(net)).items():
            p.grad = torch.from_numpy(flat_leaves(g)[name].copy())
        opt.update()
        got = {k: v.detach().numpy()
               for k, v in flat_leaves(_torch_tree(net)).items()}
        for name, want in flat_leaves(ref).items():
            assert rel_err(got[name], want) <= _TOL, (step, name)
        # the gradients themselves are left as they were
        for name, p in flat_leaves(_torch_tree(net)).items():
            np.testing.assert_array_equal(p.grad.numpy(), flat_leaves(g)[name])
    # frozen subtrees did not move at all, not even by weight decay
    for fp in _GROUPS[groups].get("freeze_paths", []):
        for name, want in flat_leaves(params).items():
            if tuple(name.split("/"))[:len(fp)] == tuple(fp):
                np.testing.assert_array_equal(got[name], want)


def test_missing_gradient_counts_as_zero_and_still_decays():
    rng = np.random.default_rng(1)
    params = _tree(rng, 1.0)
    net = _Net(params)
    opt = topt.make_optimizer(topt.make_schedule("constant", 0.1),
                              momentum=0.0, weight_decay=0.5).init(
        net.named_parameters())
    opt.update()
    for name, p in flat_leaves(_torch_tree(net)).items():
        want = flat_leaves(params)[name] * (1 - 0.1 * 0.5)
        assert rel_err(p.detach().numpy(), want) <= _TOL


def test_global_norm_matches_numpy():
    rng = np.random.default_rng(2)
    leaves = [rng.normal(size=s).astype(np.float32) for s in [(3, 4), (7,), ()]]
    want = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in leaves))
    got = float(topt.global_norm([torch.from_numpy(x) for x in leaves]))
    assert abs(got - want) <= _TOL * want
