from .mesh import (
    all_reduce_flat,
    destroy_distributed,
    init_distributed,
    local_shard,
    replicate_global,
    shard_batch,
)

__all__ = ["all_reduce_flat", "destroy_distributed", "init_distributed", "local_shard",
           "replicate_global", "shard_batch"]
