"""Distributed / parallel execution — the counterpart of
``paddle_tpu/parallel/``: SPMD over a mesh of ranks.

JAX runs one controller over a ``jax.sharding.Mesh`` and lets XLA insert
the collectives; the port runs one process per rank over
``torch.distributed`` (``torch.multiprocessing`` spawn, ``torchrun``, or
:func:`multihost.initialize` from the launcher's environment), a mesh
device is a rank (:mod:`mesh`), and the collectives are named calls
(:mod:`collectives`). ``shard_map`` keeps JAX's call shape (:mod:`compat`),
placed values are DTensors (:mod:`sharding`), and the planes on top keep
JAX's names and signatures:

* :mod:`data_parallel` — data parallelism, fsdp/tp storage layouts and
  ZeRO-1;
* :mod:`tensor_parallel` — column/row-parallel linears and a
  vocab-sharded embedding over a ``model`` axis;
* :mod:`ring_attention` — sequence parallelism over a ``seq`` axis:
  ring attention (the flash kernels #1-#3 a ring step) and Ulysses;
* :mod:`pipeline` — GPipe and 1F1B schedules over a ``pipe`` axis;
* :mod:`moe` — expert parallelism over an ``expert`` axis.
"""

from .compat import pcast, shard_map
from .mesh import (MeshSpec, current_mesh, make_mesh, local_mesh,
                   mesh_axis_size, use_mesh)
from .sharding import (replicate, shard, shard_batch, shard_params,
                       with_sharding_constraint, ShardingRules, SpecLayout)
from .collectives import (all_reduce, all_gather, reduce_scatter, broadcast,
                          all_to_all, permute_ring, axis_index)
from .data_parallel import DataParallel, Zero1DataParallel, Zero1State
from .tensor_parallel import ColumnParallelLinear, RowParallelLinear, ShardedEmbedding
from .ring_attention import (ring_attention, blockwise_attention,
                             ring_self_attention, ulysses_attention)
from .pipeline import PipelineStage, pipeline_1f1b, pipeline_spmd
from .moe import ExpertParallelMoE, init_moe_params, moe_ffn_dense
from . import multihost

__all__ = [
    "MeshSpec", "make_mesh", "local_mesh", "mesh_axis_size",
    "current_mesh", "use_mesh",
    "shard_map", "pcast",
    "replicate", "shard", "shard_batch", "shard_params",
    "with_sharding_constraint", "ShardingRules", "SpecLayout",
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all",
    "permute_ring", "axis_index",
    "DataParallel",
    "Zero1DataParallel",
    "Zero1State",
    "ColumnParallelLinear", "RowParallelLinear", "ShardedEmbedding",
    "ring_attention", "blockwise_attention", "ring_self_attention",
    "ulysses_attention",
    "PipelineStage", "pipeline_spmd", "pipeline_1f1b", "multihost",
    "ExpertParallelMoE", "init_moe_params", "moe_ffn_dense",
]
