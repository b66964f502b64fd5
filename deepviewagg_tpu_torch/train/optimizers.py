"""Optimizer / LR-schedule factories.

The port of ``deepviewagg_tpu/train/optimizers.py`` (optax there): SGD +
momentum with multi-step / poly / cosine / exponential LR schedules
(core/schedulers/lr_schedulers.py), gradient clipping, and per-submodule
discriminative LR groups (base_model.py:291-343).  The arithmetic follows the
optax chains of the JAX package, not ``torch.optim``'s habits:

  * ``clip_by_global_norm(c)``: untouched below ``c``, else ``g / norm * c``
    (no epsilon in the denominator);
  * then ``add_decayed_weights(wd)`` on EVERY parameter, norm scales and
    biases included, after clipping (sgd);
  * then ``trace = g + momentum * trace`` and ``p -= lr(step) * scale *
    trace`` (no Nesterov, no dampening);
  * ``adam`` / ``adamw`` with ``b1=0.9, b2=0.999, eps=1e-8``, bias-corrected;
    adamw's decay is decoupled and scaled by the learning rate;
  * with ``lr_scales`` / ``freeze_paths`` each label group runs its own
    chain, so the clip norm is taken per group, and frozen subtrees get no
    update at all, not even weight decay; ``lr_keywords`` labels a
    parameter by the first keyword its name contains (Pointcept's
    ``param_dicts``), before ``lr_scales``;
  * ``one_cycle``: ``torch.optim.lr_scheduler.OneCycleLR`` (cosine, two
    phases) as Pointcept sets it: from ``base_lr / 10`` up to ``base_lr``
    over the first 5% of ``total_steps``, then down to ``base_lr / 1e4``;
    with :func:`one_cycle_beta1` as ``beta1_schedule``
    Adam's ``b1`` cycles the other way, 0.95 -> 0.85 -> 0.95, and its bias
    correction takes the step's ``b1``, as ``torch.optim.Adam`` does;
  * ``grad_accumulate=k`` is ``optax.MultiSteps(chain, k)``: the gradients
    are a running mean ``acc + (g - acc) / (n + 1)`` over ``k`` mini-steps,
    parameters and optimizer state do not move on the first ``k - 1``, and
    the schedule and Adam's bias correction count real updates only (the
    inner chain's own count), not mini-steps.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

__all__ = ["make_schedule", "make_optimizer", "Optimizer", "global_norm",
           "one_cycle_beta1"]


def make_schedule(
    kind: str = "multi_step",
    base_lr: float = 0.1,
    total_steps: int = 100_000,
    milestones: Sequence[int] = (),
    gamma: float = 0.3,
    power: float = 0.9,
    warmup_steps: int = 0,
) -> Callable[[int], float]:
    """The reference's scheduler family (lr_schedulers.py): multi_step /
    poly / cosine / exponential / constant, with optional linear warmup,
    and Pointcept's ``one_cycle`` (module docstring).  Returns ``step ->
    lr``."""
    if kind == "one_cycle":
        lo = base_lr / _DIV
        return _one_cycle(total_steps, (lo, base_lr, lo / _FINAL_DIV))
    if kind == "multi_step":
        marks = sorted(int(m) for m in milestones)

        def sched(step):
            return base_lr * gamma ** sum(step >= m for m in marks)
    elif kind == "poly":
        def sched(step):
            if total_steps <= 0:
                return base_lr
            frac = 1 - min(max(step, 0), total_steps) / total_steps
            return base_lr * frac ** power
    elif kind == "cosine":
        if not total_steps > 0:
            raise ValueError(f"cosine schedule needs total_steps > 0, got "
                             f"{total_steps}")

        def sched(step):
            count = min(step, total_steps)
            return base_lr * 0.5 * (1 + math.cos(math.pi * count / total_steps))
    elif kind == "exponential":
        every = max(total_steps // 30, 1)

        def sched(step):
            if step <= 0 or gamma == 0:
                return base_lr
            return base_lr * gamma ** (step / every)
    elif kind == "constant":
        def sched(step):
            return base_lr
    else:
        raise ValueError(kind)
    if not warmup_steps:
        return sched

    def warmed(step):
        if step < warmup_steps:
            return base_lr * min(max(step, 0), warmup_steps) / warmup_steps
        return sched(step - warmup_steps)

    return warmed


# Pointcept's OneCycleLR settings: the first phase's share of the steps,
# the start's and the end's divisors of the peak, and beta1's range
_PCT_START, _DIV, _FINAL_DIV = 0.05, 10.0, 1000.0
_BETA1 = (0.85, 0.95)


def _one_cycle(total_steps: int, values):
    """``OneCycleLR``'s two cosine phases through ``(start, peak, end)``:
    the first ends at step ``_PCT_START * total_steps - 1``, the second at
    ``total_steps - 1`` (later steps stay at ``end``)."""
    if not total_steps > 0:
        raise ValueError(f"one_cycle needs total_steps > 0, got "
                         f"{total_steps}")
    start, peak, end = values
    mid = float(_PCT_START * total_steps) - 1
    last = total_steps - 1

    def anneal(a, b, pct):
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

    def sched(step):
        step = min(step, last)
        if step <= mid:
            return anneal(start, peak, step / mid if mid > 0 else 1.0)
        return anneal(peak, end, (step - mid) / (last - mid))

    return sched


def one_cycle_beta1(total_steps: int):
    """``OneCycleLR``'s cycling of Adam's ``b1``: 0.95 -> 0.85 over the
    first phase, back to 0.95 over the second."""
    base, top = _BETA1
    return _one_cycle(total_steps, (top, base, top))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, a 0-d float32 tensor."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


class _Group:
    """The parameters of one label with their LR multiplier and state."""

    def __init__(self, params: List[nn.Parameter], scale: float):
        self.params = params
        self.scale = scale
        self.state: Dict[str, List[torch.Tensor]] = {}

    def zeros(self, key: str) -> List[torch.Tensor]:
        if key not in self.state:
            self.state[key] = [torch.zeros_like(p) for p in self.params]
        return self.state[key]


class Optimizer:
    """One update rule over named parameter groups (see the module
    docstring).  :meth:`init` binds it to a model's named parameters (the
    counterpart of ``tx.init(params)``); :meth:`update` takes one mini-step
    from the parameters' ``.grad`` (None counts as zero);
    :meth:`state_dict` / :meth:`load_state_dict` save and restore the
    momentum or Adam moments per group, the counts and the accumulator."""

    def __init__(self, schedule, optimizer, momentum, weight_decay, grad_clip,
                 lr_scales, freeze_paths, grad_accumulate: int = 1,
                 lr_keywords=None, beta1_schedule=None):
        if optimizer not in ("sgd", "adam", "adamw"):
            raise ValueError(optimizer)
        if int(grad_accumulate) < 1:
            raise ValueError(f"grad_accumulate must be >= 1, got "
                             f"{grad_accumulate}")
        self.grad_accumulate = int(grad_accumulate)
        self.count = 0        # real updates taken: the schedule's position
        self.mini_step = 0    # mini-steps accumulated toward the next one
        self.schedule = schedule
        self.optimizer = optimizer
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.lr_scales = dict(lr_scales or {})
        self.lr_keywords = dict(lr_keywords or {})
        self.beta1_schedule = beta1_schedule
        self.freeze_paths = [tuple(p) for p in (freeze_paths or [])]
        self.groups: List[_Group] = []

    def init(self, named_params) -> "Optimizer":
        """Group ``(name, parameter)`` pairs by label: frozen prefixes get no
        group, a name containing an ``lr_keywords`` key takes its scale,
        else ``lr_scales`` keys match the first name component."""
        by_label: Dict[str, List[nn.Parameter]] = {}
        scales = dict(self.lr_scales)
        for name, p in named_params:
            path = tuple(name.split("."))
            if any(path[:len(fp)] == fp for fp in self.freeze_paths):
                continue
            word = next((w for w in self.lr_keywords if w in name), None)
            if word is not None:
                label = "keyword:" + word
                scales[label] = self.lr_keywords[word]
            else:
                label = path[0] if path[0] in self.lr_scales \
                    else "__default__"
            by_label.setdefault(label, []).append(p)
        self.groups = [_Group(ps, scales.get(label, 1.0))
                       for label, ps in by_label.items()]
        return self

    @torch.no_grad()
    def update(self) -> bool:
        """One mini-step; returns whether the parameters moved.  A real
        update runs at schedule position ``count``, the real updates taken
        before it."""
        grads = [[torch.zeros_like(p) if p.grad is None else p.grad.clone()
                  for p in group.params] for group in self.groups]
        if self.grad_accumulate > 1:
            n = self.mini_step
            for group, gs in zip(self.groups, grads):
                acc = group.zeros("acc")
                torch._foreach_add_(acc, torch._foreach_div(
                    torch._foreach_sub(gs, acc), float(n + 1)))
            if n < self.grad_accumulate - 1:
                self.mini_step += 1
                return False
            # the mean goes through the chain (which may scale it in
            # place); then the accumulator starts again from zero
            grads = [[a.clone() for a in group.state["acc"]]
                     for group in self.groups]
            for group in self.groups:
                torch._foreach_zero_(group.state["acc"])
            self.mini_step = 0
        for group, gs in zip(self.groups, grads):
            self._update_group(group, gs, self.count)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """``{"count", "mini_step", "groups": [{key: [tensor per
        parameter]}]}``, copies of the state."""
        return {"count": self.count, "mini_step": self.mini_step,
                "groups": [{k: [t.detach().clone() for t in v]
                            for k, v in g.state.items()}
                           for g in self.groups]}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` into an optimizer bound to the same
        parameters (same groups, same shapes)."""
        if len(state["groups"]) != len(self.groups):
            raise ValueError(f"{len(state['groups'])} groups saved, "
                             f"{len(self.groups)} here")
        for group, saved in zip(self.groups, state["groups"]):
            for key, tensors in saved.items():
                if len(tensors) != len(group.params) or any(
                        t.shape != p.shape
                        for t, p in zip(tensors, group.params)):
                    raise ValueError(f"optimizer state {key!r} does not fit "
                                     "the parameters")
            group.state = {
                key: [t.to(device=p.device, dtype=p.dtype).clone()
                      for t, p in zip(tensors, group.params)]
                for key, tensors in saved.items()}
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def _update_group(self, group: _Group, grads: List[torch.Tensor],
                      step: int) -> None:
        params = group.params
        lr = self.schedule(step) * group.scale
        if self.grad_clip:
            norm = global_norm(grads)
            # below the threshold the gradients pass untouched
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        if self.optimizer == "sgd":
            if self.weight_decay:
                torch._foreach_add_(grads, params, alpha=self.weight_decay)
            if self.momentum:
                trace = group.zeros("trace")
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                grads = trace
            torch._foreach_add_(params, grads, alpha=-lr)
            return
        b1, b2, eps = 0.9, 0.999, 1e-8
        if self.beta1_schedule is not None:
            b1 = self.beta1_schedule(step)
        mu, nu = group.zeros("mu"), group.zeros("nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        # the bias corrections in float32, as optax computes them: in double,
        # 1 - b2**t differs by 1e-5 relative at small t, where 1 - 0.999 is
        # taken from the float32 nearest to 0.999
        t = torch.tensor(step + 1, dtype=torch.float32)
        one = torch.tensor(1.0, dtype=torch.float32)
        upd = torch._foreach_div(
            mu, float(one - torch.tensor(b1, dtype=torch.float32) ** t))
        denom = torch._foreach_div(
            nu, float(one - torch.tensor(b2, dtype=torch.float32) ** t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(upd, denom)
        if self.optimizer == "adamw" and self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)


def make_optimizer(
    schedule: Callable[[int], float],
    optimizer: str = "sgd",
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    grad_clip: Optional[float] = None,
    lr_scales: Optional[Dict[str, float]] = None,
    freeze_paths: Optional[Sequence[Sequence[str]]] = None,
    grad_accumulate: int = 1,
    lr_keywords: Optional[Dict[str, float]] = None,
    beta1_schedule: Optional[Callable[[int], float]] = None,
) -> Optimizer:
    """An unbound :class:`Optimizer`; ``TrainState.create`` binds it to the
    model's parameters, keyed by their names (the flax paths the modules
    carry).

    ``lr_scales`` maps top-level sub-module names to LR multipliers — the
    discriminative-LR groups the reference builds from config
    (base_model.py:291-343, e.g. a lower LR on a pretrained 2D tower).

    ``freeze_paths``: name prefixes (e.g. ``[("branch_l0", "tower")]``)
    whose parameters receive NO updates at all — not even weight decay,
    which would otherwise shrink frozen pretrained towers despite their zero
    gradients (ref 'frozen' tower option, modalities/image.py:737).

    ``grad_accumulate``: mini-steps per real update (``optax.MultiSteps``).

    ``lr_keywords``: LR multipliers for the parameters whose names contain
    a keyword (Pointcept's ``param_dicts``, e.g. ``{"block": 0.1}``);
    ``beta1_schedule``: ``step -> b1`` for Adam (:func:`one_cycle_beta1`).
    """
    return Optimizer(schedule, optimizer, momentum, weight_decay, grad_clip,
                     lr_scales, freeze_paths, grad_accumulate, lr_keywords,
                     beta1_schedule)
