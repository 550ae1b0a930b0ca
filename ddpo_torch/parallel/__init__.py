from ddpo_torch.parallel.collectives import (
    GradientAllReduce,
    all_gather_array,
    all_gather_strings,
    all_processes_equal,
    digest,
    process_barrier,
    process_count,
    process_index,
    sharded_softmax,
    softmax_ref,
    sync_state_across_devices,
    worker_sum,
)
from ddpo_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    create_mesh,
    destroy_distributed,
    global_batch_size,
    gradient_group,
    local_batch_size,
    local_rank,
    local_shard,
    maybe_initialize_distributed,
)

__all__ = [
    "GradientAllReduce", "Mesh", "MeshConfig", "all_gather_array", "create_mesh", "all_gather_strings", "all_processes_equal",
    "destroy_distributed", "digest", "global_batch_size", "gradient_group",
    "local_batch_size", "local_rank", "local_shard", "maybe_initialize_distributed",
    "process_barrier", "process_count",
    "process_index", "sharded_softmax", "softmax_ref", "sync_state_across_devices",
    "worker_sum",
]
