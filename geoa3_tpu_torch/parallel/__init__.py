"""Process groups and sharding: data and tensor parallel over
torch.distributed (port of geoa3_tpu/parallel)."""

from geoa3_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    make_sharded_attack_fn,
    make_sharded_train_step,
    param_shardings,
    replicate,
    shard_attack_batch,
    shard_batch,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_attack_batch",
    "shard_batch",
    "replicate",
    "param_shardings",
    "make_sharded_attack_fn",
    "make_sharded_train_step",
]
