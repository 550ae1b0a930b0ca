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
from ddpo_torch.parallel.sharding import (
    Shard,
    TensorParallel,
    gather_state_dict,
    param_specs,
    place_train_state,
    shard_module,
    shard_state_dict,
    unet_partition_rules,
)
from ddpo_torch.parallel.tensor import copy_to_tp, reduce_from_tp, row_parallel_linear

__all__ = [
    "GradientAllReduce", "Mesh", "MeshConfig", "Shard", "TensorParallel", "all_gather_array",
    "all_gather_strings", "all_processes_equal", "copy_to_tp", "create_mesh",
    "destroy_distributed", "digest", "gather_state_dict", "global_batch_size",
    "gradient_group", "local_batch_size", "local_rank", "local_shard",
    "maybe_initialize_distributed", "param_specs", "place_train_state", "process_barrier",
    "process_count", "process_index", "reduce_from_tp", "row_parallel_linear",
    "shard_module", "shard_state_dict", "sharded_softmax", "softmax_ref",
    "sync_state_across_devices", "unet_partition_rules", "worker_sum",
]
