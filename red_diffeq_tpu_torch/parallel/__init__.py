from red_diffeq_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec, ShardedTensor, batch_sharding,
    batch_shot_sharding, device_put, make_mesh, replicated,
    shard_inversion_inputs,
)
