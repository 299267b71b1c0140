"""Parallelism (counterpart of cotr_tpu/parallel): process and local device
meshes, Megatron tensor parallelism for the transformer, and the optimizer
state's layouts (moments follow their parameter; ZeRO-1)."""

from cotr_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicate, replicated, shard_batch)

__all__ = ["batch_sharding", "make_mesh", "replicate", "replicated",
           "shard_batch"]
