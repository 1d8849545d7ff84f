"""The multi-device runtime (counterpart of `crvqa_tpu/parallel/`): one
process per device over `torch.distributed`. `mesh` lays the ranks out as
the JAX mesh lays out devices and holds the collectives; `zero` shards the
optimizer state over the data group; `tp` splits stage 2's heads and FFN
units over the model group; `dryrun` drives them over gloo ranks on the
CPU.

The JAX package's `batch_sharding`, `replicated_sharding` and
`constrain_opt_state` place arrays for XLA and have no counterpart in a
process-per-device runtime: a rank's batch is its block
(`process_local_slice`), its parameters are replicated unless `tp` splits
them and `ZeroOptimizer` keeps its state sharded. Its `shard_params_tp`
and `shard_scores_tp` are `TensorParallel.shard` here, over the split
that `tensor_parallel` derives from `param_partition_spec`.
"""
from .mesh import (MeshConfig, host_all_gather, host_all_gather_local,
                   initialize_multihost, is_main_process, make_mesh,
                   process_local_slice, shard_batch)
from .tp import (TensorParallel, enable_tp, param_partition_spec,
                 tensor_parallel)
from .zero import ZeroOptimizer, ZeroPartition, zero_optimizer


def shard_opt_state(opt_state, zero: ZeroPartition):
    """`opt_state` with the leaves this rank does not own dropped (call once
    after init and any resume)."""
    return zero.shard_state(opt_state)


__all__ = [
    "MeshConfig",
    "make_mesh",
    "shard_batch",
    "host_all_gather",
    "host_all_gather_local",
    "is_main_process",
    "process_local_slice",
    "initialize_multihost",
    "shard_opt_state",
    "ZeroOptimizer", "ZeroPartition", "zero_optimizer",
    "param_partition_spec", "TensorParallel", "tensor_parallel",
    "enable_tp",
]
