from .data_parallel import (GlobalBatchNorm, RowShard, active_shard,
                            all_reduce_grads, draw_rows, gather_rows,
                            global_batch_norm, shard_rows, sharded,
                            sum_over_ranks)
from .mesh import (Mesh, batch_sharding, init_multihost, local_device_count,
                   make_mesh, pad_to_multiple, replicate, replicated,
                   shard_batch)

__all__ = ["GlobalBatchNorm", "RowShard", "active_shard", "all_reduce_grads",
           "draw_rows", "gather_rows", "global_batch_norm", "shard_rows",
           "sharded", "sum_over_ranks", "Mesh", "batch_sharding",
           "init_multihost", "local_device_count", "make_mesh",
           "pad_to_multiple", "replicate", "replicated", "shard_batch"]
