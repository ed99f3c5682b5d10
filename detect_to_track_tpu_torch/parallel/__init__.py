"""data parallelism over torch.distributed (port of the JAX package's
`parallel/`): one process per card, DistributedDataParallel for the
training step, the pair batch sharded over the ranks for detection."""

from .mesh import (
    Mesh,
    any_over_ranks,
    barrier_sync,
    init_distributed,
    launched,
    local_value,
    make_mesh,
    make_parallel_detect,
    make_parallel_train_step,
    mean_over_ranks,
    rank_device,
    replicate,
    shard_batch,
)
