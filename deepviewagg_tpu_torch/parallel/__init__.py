"""Data and view parallelism over ``torch.distributed``: one process per
device (NCCL on the card, gloo on the CPU), the counterpart of the JAX
package's ``parallel/`` (``shard_map`` over a device mesh)."""
