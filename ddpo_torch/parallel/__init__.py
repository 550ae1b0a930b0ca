from ddpo_torch.parallel.collectives import (
    process_count,
    process_index,
    sharded_softmax,
    softmax_ref,
    worker_sum,
)

__all__ = ["process_count", "process_index", "sharded_softmax", "softmax_ref", "worker_sum"]
