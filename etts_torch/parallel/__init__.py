"""Data, tensor and sequence parallelism (port of ``etts/parallel``):
process groups, meshes and the global batch's rows (``mesh``), the
global-batch semantics of a data- or sequence-parallel train step
(``collectives``), and tensor parallelism's placements and sharded
layers (``tp``)."""
from . import tp
from .collectives import (average_gradients, gather_rows, global_mean,
                          mean_over_ranks, rank_world, sharded, sharded_step)
from .mesh import (add_multihost_args, barrier, init_multihost, is_primary,
                   local_batch_slice, local_device, local_shard, make_mesh,
                   maybe_init_multihost, replicate, shard_batch)

__all__ = ["add_multihost_args", "average_gradients", "barrier",
           "gather_rows", "global_mean", "init_multihost", "is_primary",
           "local_batch_slice", "local_device", "local_shard", "make_mesh",
           "maybe_init_multihost", "mean_over_ranks", "rank_world",
           "replicate", "shard_batch", "sharded", "sharded_step", "tp"]
