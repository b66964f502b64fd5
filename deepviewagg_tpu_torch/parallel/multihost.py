"""Process-group bring-up and process-sharded input.

The port of ``deepviewagg_tpu/parallel/multihost.py``.  JAX runs one process
per host over all of its devices; PyTorch runs one process per device, so
"host" reads "process" here:

  * :func:`initialize` brings up ``torch.distributed`` (NCCL when the
    process's device is a card, gloo on the CPU), from a torchrun-style
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    from explicit arguments, or as a world of one;
  * each process builds the batches of ITS device only
    (:class:`HostShardedLoader` splits the sample space by rank);
  * checkpoints and logs are written by rank 0 only (:func:`is_primary`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_primary", "primary_first", "torchrun_env",
           "HostShardedLoader", "global_device_batch", "TIMEOUT"]

# every collective of a process group gives up after this long (a rank
# that died leaves the others waiting in one)
TIMEOUT = datetime.timedelta(minutes=30)


def torchrun_env() -> bool:
    """Whether the process was started by torchrun or a launcher that sets
    the same variables."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Bring up the default process group; returns whether this call did
    (False: it was up already).  Under a torchrun-style environment and no
    ``num_processes``, ``env://``; with ``num_processes > 1``,
    ``tcp://<coordinator_address>`` (``host:port``) at rank
    ``process_id``; otherwise a world of one (an in-process store, no
    socket).  The backend is NCCL where ``device`` is a card (with an
    index, it becomes the process's current device), gloo on the CPU."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        backend = "nccl"
    if num_processes is None and torchrun_env():
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    elif num_processes is not None and num_processes > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
    return True


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def primary_first():
    """The block runs on rank 0 first and on the other ranks after it (e.g.
    a dataset whose cache the first process writes and the others read)."""
    if not is_primary():
        dist.barrier()
    yield
    if dist.is_initialized() and is_primary():
        dist.barrier()


class HostShardedLoader:
    """Wrap a BatchLoader-style iterable so each process consumes a
    disjoint shard of the sample space: sample index ``i`` belongs to
    process ``i % process_count`` (defaults: this process's rank and the
    world size, 0 and 1 without a process group)."""

    def __init__(self, make_loader, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        up = dist.is_initialized()
        self.make_loader = make_loader
        self.pi = ((dist.get_rank() if up else 0) if process_index is None
                   else process_index)
        self.pc = ((dist.get_world_size() if up else 1)
                   if process_count is None else process_count)

    def __iter__(self) -> Iterator:
        for i, batch in enumerate(self.make_loader()):
            if i % self.pc == self.pi:
                yield batch


def global_device_batch(per_device_batches: Sequence, device):
    """This process's batch on its device.  The JAX function assembles one
    host's batches for its local devices into one sharded array; PyTorch
    runs one device per process, so the list holds exactly one collated
    numpy batch, moved to ``device``."""
    from ..data.collate import batch_to_torch, device_view

    if len(per_device_batches) != 1:
        raise ValueError(f"one batch per process, got "
                         f"{len(per_device_batches)}")
    return batch_to_torch(device_view(per_device_batches[0]), device)
