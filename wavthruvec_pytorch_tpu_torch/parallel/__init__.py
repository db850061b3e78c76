"""Data parallelism over cards, one process per card (JAX package:
``parallel/``)."""

from wavthruvec_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    globalize_state,
    group_active,
    is_main_process,
    local_batch_size,
    maybe_distributed_init,
    mean_scalars,
    mesh_for_batch,
    process_shard,
    rank,
    shard_batch,
    world_size,
)
