"""``run_tower``'s ``remat`` and ``frozen`` in the PyTorch port.

Rematerialization changes no number: with float32 operands the tower's
output and every parameter gradient under ``remat=True`` (the backward pass
runs the tower again) and ``remat='convs'`` (the convolutions' outputs are
kept, the rest is recomputed) are bit-equal to ``remat=False``, for the tower
alone and for a whole train step on a flat and on a crop-ladder batch; with
the production bf16 activations the recomputation repeats the same casts, so
the gradients are bit-equal there too.  ``frozen`` gives the JAX package's
output and no tower gradient."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models.segmentation import (MultimodalSeg,
                                                       init_parameters)
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.train import optimizers as topt
from deepviewagg_tpu_torch.train import step as tstep
from deepviewagg_tpu_torch.utils.from_jax import (load_flax_variables,
                                                  to_flax_tree)
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             flat_leaves, jax_ladder_batch, jax_tiny_batch,
                             jax_variables, rel_err, torch_batch)

_TOWERS = {
    "resnet18_l2": lambda: tt.ResNet18(out_level=2),
    "resnet18_ppm": lambda: tt.ResNet18PPM(out_channels=16),
}


def _images(seed=0, shape=(2, 48, 32, 3)):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))


def _tower_run(name, remat, bf16, saved=None):
    """Output and parameter gradients of ``sum(y * w)`` of a seeded tower;
    ``saved`` collects the bytes autograd keeps for the backward pass."""
    tower = _TOWERS[name]().train()
    init_parameters(tower, torch.Generator().manual_seed(1))
    hooks = contextlib.nullcontext() if saved is None else (
        torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel() * t.element_size()) or t,
            lambda t: t))
    with hooks:
        if bf16:
            y = tt.run_tower(tower, _images(), True, remat=remat, bf16=True)
        else:
            with tt.f32_convs():
                y = tt.run_tower(tower, _images(), True, remat=remat,
                                 bf16=False)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(y.shape)).astype(np.float32))
    if bf16:
        (y * w).sum().backward()
    else:
        with tt.f32_convs():     # a recomputation reads the switch again
            (y * w).sum().backward()
    return y.detach(), {k: p.grad.clone() for k, p in tower.named_parameters()}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("remat", [True, "convs"])
@pytest.mark.parametrize("tower", sorted(_TOWERS))
def test_remat_is_bit_equal_to_no_remat(tower, remat, bf16):
    y0, g0 = _tower_run(tower, False, bf16)
    y1, g1 = _tower_run(tower, remat, bf16)
    assert torch.equal(y0, y1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert sum(bool(g.abs().max() > 0) for g in g1.values()) > 0.9 * len(g1)


def test_convs_remat_runs_no_convolution_twice():
    """Forward convolutions executed over one forward and backward pass:
    ``True`` runs each twice, ``'convs'`` once (its recomputation takes the
    kept outputs), and both keep only the tower's input for autograd where
    no remat keeps every activation."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountConvs(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.aten.convolution.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    convs, kept = {}, {}
    for remat in (False, "convs", True):
        saved = []
        with CountConvs() as counter:
            _tower_run("resnet18_ppm", remat, True, saved)
        convs[remat], kept[remat] = counter.n, sum(saved)
    n = sum(isinstance(m, tt.Conv2dWS)
            for m in _TOWERS["resnet18_ppm"]().modules())
    assert convs == {False: n, "convs": n, True: 2 * n}
    assert kept[False] > 100 * kept["convs"] and kept["convs"] == kept[True] > 0


@pytest.mark.parametrize("bad", ["conv", "all", None, 2])
def test_bad_remat_value_raises_as_in_jax(bad):
    tower = _TOWERS["resnet18_l2"]()
    with pytest.raises(ValueError, match="remat must be False, True or 'convs'"):
        tt.run_tower(tower, _images(), True, remat=bad)
    with pytest.raises(ValueError, match="remat must be False, True or 'convs'"):
        jt.run_tower(lambda x, t: x, jnp.zeros((1, 8, 8, 3)), True, remat=bad)


def test_no_remat_outside_autograd_and_when_frozen(monkeypatch):
    from torch.utils import checkpoint as ckpt

    calls = []
    inner = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    tower = _TOWERS["resnet18_l2"]().train()
    init_parameters(tower, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tt.run_tower(tower, _images(), True, remat="convs")
    tt.run_tower(tower, _images(), True, remat=True, frozen=True)
    assert not calls
    tt.run_tower(tower, _images(), True, remat=True)
    assert calls == [1]


def test_frozen_tower_runs_in_eval_mode_outside_autograd():
    tower = _TOWERS["resnet18_l2"]().train()
    init_parameters(tower, torch.Generator().manual_seed(1))
    modes = []
    tower.register_forward_hook(lambda m, a, o: modes.append(m.training))
    live = tt.run_tower(tower, _images(), True)
    frozen = tt.run_tower(tower, _images(), True, frozen=True)
    assert modes == [True, False] and tower.training
    assert torch.equal(live, frozen)
    assert live.requires_grad and not frozen.requires_grad
    assert frozen.grad_fn is None


@pytest.mark.parametrize("remat", [False, "convs"])
def test_run_tower_matches_jax_with_remat_and_frozen(remat):
    """Output and parameter gradients against the JAX package's ``run_tower``
    under the same ``remat`` (float32, 1e-5); frozen: equal output, zero
    gradient there and none here."""
    images = _images(3, (2, 32, 32, 3)).numpy()
    jtower = jt.ResNet18(out_level=1)
    variables = jax_variables(jtower, images, False, seed=4)
    weight = np.random.default_rng(5).normal(size=(2, 8, 8, 64)).astype(
        np.float32)

    def loss(params, frozen):
        y = jt.run_tower(jtower.bind({"params": params}), images, True,
                         remat=remat, frozen=frozen, bf16=False)
        return (y * weight).sum(), y

    with jt.f32_convs():
        (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(
            variables["params"], False)
        (_, ref_frozen), zero = jax.value_and_grad(loss, has_aux=True)(
            variables["params"], True)
    tower = tt.ResNet18(out_level=1).train()
    load_flax_variables(tower, variables)
    with tt.f32_convs():
        y = tt.run_tower(tower, torch.from_numpy(images), True, remat=remat,
                         bf16=False)
        (y * torch.from_numpy(weight)).sum().backward()
        y_frozen = tt.run_tower(tower, torch.from_numpy(images), True,
                                remat=remat, frozen=True, bf16=False)
    assert rel_err(y.detach().numpy(), np.asarray(ref)) <= 1e-5
    assert rel_err(y_frozen.numpy(), np.asarray(ref_frozen)) <= 1e-5
    got, want = flat_leaves(to_flax_tree(tower, "grads")), flat_leaves(grads)
    assert max(rel_err(got[k], want[k]) for k in want) <= 1e-5
    assert not any(np.asarray(g).any() for g in flat_leaves(zero).values())


# --- the whole train step ----------------------------------------------------

def _step(batch, remat, frozen=False, f32=True):
    spec = flagship_spec(**TINY_SPEC)
    spec = dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, remat_tower=remat, frozen=frozen,
                                  tower_bf16=not f32))
        for lvl, b in spec.branches))
    model = MultimodalSeg(spec, device="cpu", seed=5)
    state = tstep.TrainState.create(model, topt.make_optimizer(
        topt.make_schedule("constant", 0.1), grad_clip=10.0))
    ctx = tt.f32_convs() if f32 else contextlib.nullcontext()
    with ctx:
        _, metrics = tstep.make_train_step(model)(state, torch_batch(batch),
                                                  None)
    grads = {k: None if p.grad is None else p.grad.clone()
             for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads, model


@pytest.mark.parametrize("kind", ["flat", "ladder"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_train_step_is_bit_equal_under_every_remat_mode(kind, f32):
    batch = jax_tiny_batch()[0] if kind == "flat" else jax_ladder_batch()[0]
    loss0, g0, model = _step(batch, False, f32=f32)
    assert model.branch_l0.remat_tower is False
    for remat in (True, "convs"):
        loss, g, model = _step(batch, remat, f32=f32)
        assert model.branch_l0.remat_tower == remat
        assert loss == loss0
        for k in g0:
            assert torch.equal(g[k], g0[k]), (remat, k)


@pytest.mark.parametrize("kind", ["flat", "ladder"])
def test_frozen_branch_trains_everything_but_its_tower(kind):
    batch = jax_tiny_batch()[0] if kind == "flat" else jax_ladder_batch()[0]
    loss0, g0, _ = _step(batch, "convs")
    loss, g, model = _step(batch, "convs", frozen=True)
    assert loss == loss0                    # the same forward
    tower = [k for k in g if k.startswith("branch_l0.tower.")]
    assert tower and all(g[k] is None for k in tower)
    rest = [k for k in g if k not in tower]
    assert all(torch.equal(g[k], g0[k]) for k in rest)


def test_default_branch_spec_asks_for_convs_remat():
    from deepviewagg_tpu.models.segmentation import BranchSpec as JaxBranchSpec
    from deepviewagg_tpu_torch.models.segmentation import BranchSpec

    assert BranchSpec().remat_tower == JaxBranchSpec().remat_tower == "convs"
    assert flagship_spec().branches[0][1].remat_tower == "convs"
