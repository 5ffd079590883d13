"""Data parallelism over rays (``torch.distributed``)."""

from vdnerf_tpu_torch.parallel.mesh import (
    World,
    active,
    all_reduce_grads,
    broadcast_parameters,
    env_world_size,
    global_sum,
    init_from_env,
    rank_seed,
    shard_batch,
    world_from_env,
)

__all__ = [
    "World", "active", "all_reduce_grads", "broadcast_parameters", "env_world_size",
    "global_sum", "init_from_env", "rank_seed", "shard_batch", "world_from_env",
]
