"""Data and tensor parallelism over torch.distributed (JAX: parallel/)."""
from .mesh import (Axis, DataShard, Mesh, batch_shardings, init_distributed,
                   make_mesh, param_shardings, replicated, shard_batch,
                   shard_model)

__all__ = ["Axis", "DataShard", "Mesh", "batch_shardings",
           "init_distributed", "make_mesh", "param_shardings", "replicated",
           "shard_batch", "shard_model"]
