"""Process group, mesh, batch sharding and collectives of the port (the
JAX package's ``parallel``).

Left out, as TPU adapters of the JAX package: ``batch_sharding`` and
``replicated_sharding`` (``jax.sharding`` objects; the port moves each
shard with ``shard_batch`` and each replica with ``replicate``).
"""

from .collectives import (all_reduce_flat, draw_rows, global_sum,
                          plain_share, sum_over_ranks)
from .mesh import (Mesh, build_then_barrier, cross_process_barrier,
                   in_group, is_primary, make_mesh,
                   maybe_initialize_distributed, process_count,
                   process_index, replicate, shard_batch, training_mesh)

__all__ = ["Mesh", "make_mesh", "training_mesh", "shard_batch", "replicate",
           "is_primary", "in_group", "process_index", "process_count",
           "maybe_initialize_distributed", "cross_process_barrier",
           "build_then_barrier", "plain_share", "global_sum", "draw_rows",
           "all_reduce_flat", "sum_over_ranks"]
