from workoutdetector_tpu_torch.parallel.mesh import (batch_sharding,
                                                     create_mesh,
                                                     local_batch_size,
                                                     replicated_sharding,
                                                     shard_batch)

__all__ = [
    "create_mesh", "batch_sharding", "replicated_sharding", "shard_batch",
    "local_batch_size"
]
