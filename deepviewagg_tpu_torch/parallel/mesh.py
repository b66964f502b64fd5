"""The process mesh and the data- and view-parallel step wrappers.

The port of ``deepviewagg_tpu/parallel/mesh.py``.  JAX runs the step under
``shard_map`` over a device mesh; here every rank of a ``torch.distributed``
world runs the port's ``step(state, batch, generator)`` on its own batch,
parameters replicated, and the collectives that ``shard_map`` inserts are
called by the step itself: the gradient, loss and running-statistics mean
(``make_train_step(group=...)``), the masked batch norms' statistics
(``nn.norm.bn_process_group``) and, under view parallelism, the towers'
all-gather (``modules.image_encoders.view_shard_group``).

Ranks form a ``(data, model)`` grid with the model axis minor, as in
``make_hybrid_mesh``: rank ``r`` is data index ``r // n_model`` and model
index ``r % n_model``.  A rank's *data group* holds the ranks of its model
index (over which the batches differ), its *model group* the ranks of its
data index (which share one batch and split its images).

``stack_batches`` has no counterpart: each rank holds its own batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..modules.image_encoders import view_shard_group
from ..nn.norm import bn_process_group
from .collectives import broadcast_

__all__ = ["Mesh", "make_mesh", "make_hybrid_mesh", "replicate",
           "unreplicate", "fold_in", "data_parallel_step",
           "hybrid_parallel_step"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data x n_model`` grid and its groups."""

    n_data: int
    n_model: int
    rank: int
    world: object
    data_group: object
    model_group: object

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def make_mesh() -> Mesh:
    """Every rank of the world on the data axis."""
    return make_hybrid_mesh(n_model=1)


def make_hybrid_mesh(n_model: int = 2) -> Mesh:
    """``(data x model)``: ``model`` is the minor axis, so a view-parallel
    all-gather runs among consecutive ranks (the cards of one host when
    ranks are numbered host by host).  Every rank must call it (it creates
    the groups); the default process group must be up."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"the model axis ({n_model}) must divide the world "
                         f"size ({world})")
    n_data = world // n_model
    whole = dist.group.WORLD

    def groups(members):
        """The group of each member list holding this rank; every rank
        creates every group, in the same order."""
        mine = None
        for ranks in members:
            g = whole if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data = groups([list(range(k, world, n_model)) for k in range(n_model)])
    model = groups([list(range(d * n_model, (d + 1) * n_model))
                    for d in range(n_data)])
    return Mesh(n_data, n_model, rank, whole, data, model)


def replicate(model: nn.Module, mesh: Optional[Mesh] = None) -> nn.Module:
    """Overwrite every parameter and buffer with rank 0's; returns the
    model."""
    group = None if mesh is None else mesh.world
    broadcast_([p.data for p in model.parameters()]
               + list(model.buffers()), src=0, group=group)
    return model


def unreplicate(model: nn.Module) -> dict:
    """The model's parameters and buffers as host numpy arrays by name."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def fold_in(generator: Optional[torch.Generator],
            index: int) -> Optional[torch.Generator]:
    """The counterpart of ``jax.random.fold_in(rng, index)``: index 0 keeps
    ``generator`` itself (a one-rank world draws what a plain run draws);
    any other index gets a fresh generator seeded from one draw of
    ``generator`` mixed with the index, so ranks of one index draw the
    same masks and ranks of two indices different ones, step after
    step."""
    if generator is None or index == 0:
        return generator
    draw = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    words = np.random.SeedSequence([draw, index]).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=generator.device).manual_seed(seed)


def _lift(step_fn: Callable, mesh: Mesh, bn_group, shard_group) -> Callable:
    def run(state, batch, generator: Optional[torch.Generator] = None):
        with bn_process_group(bn_group), view_shard_group(shard_group):
            return step_fn(state, batch, fold_in(generator, mesh.data_rank))

    return run


def data_parallel_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """Lift a one-device ``step_fn(state, batch, generator) -> (state,
    metrics)`` to the data axis: every rank calls the result on its own
    batch.  The step must be built with ``make_train_step(...,
    group=mesh.data_group)``, which takes the mean of the gradients, the
    loss and the running statistics over it; the masked batch norms sum
    their statistics over it (sync BN); the dropout generator is folded
    with the data index.  ``metrics["preds"]`` stays this rank's,
    ``loss`` and ``grad_norm`` are replicated."""
    return _lift(step_fn, mesh, mesh.data_group, None)


def hybrid_parallel_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """Lift a step to the ``(data x model)`` grid: distinct batches over
    the data axis (as in :func:`data_parallel_step`) and view parallelism
    over the model axis: each rank of a model group runs the 2D towers on
    its block of the batch's images and all-gathers the feature maps, the
    3D path replicated within the group.  Build the step with
    ``make_train_step(..., group=mesh.world)``.

    Towers must use GroupNorm: a tower BatchNorm would normalize with its
    own block's statistics (zero-pad images included), unlike the unsharded
    model; ``cli.train`` refuses the combination.

    Why a mean over the whole world is exact: after the gather everything
    downstream is replicated across the model group, so the gradients of
    the other parameters are equal across it, while the gather's backward
    (a reduce-scatter) hands each rank ``n_model`` times its image block's
    tower gradient; the mean over ``n_data * n_model`` ranks then gives the
    mean over the data axis of each batch's full gradient, for every
    parameter.  The masked batch norms sum raw sums and counts over the
    world, which is invariant to the ``n_model``-fold replication.  The
    dropout generator is folded with the data index only, so the
    post-gather compute is identical across a model group."""
    return _lift(step_fn, mesh, mesh.world, mesh.model_group)
