from boxfusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_inference,
    shard_train_step,
)

__all__ = [
    "make_mesh",
    "param_shardings",
    "batch_sharding",
    "shard_inference",
    "shard_train_step",
]
