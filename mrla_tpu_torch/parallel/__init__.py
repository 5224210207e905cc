"""Data, tensor and pipeline parallelism with ``torch.distributed``: NCCL
on cards, gloo on the CPU (and for ranks that share a card).  The JAX
package's names carry over where its functions do: ``init_distributed``,
``is_main_process``, ``all_gather_metrics`` (``launch.py``), ``make_mesh``,
``local_mesh``, ``batch_sharding``, ``replicated``, ``shard_batch``
(``mesh.py``), ``tp_shardings``, ``shard_train_state`` (``sharding.py``),
``make_pipelined_vit``, ``pipeline_shardings``, ``stack_block_params``,
``unstack_block_params`` (``pipeline.py``)."""

from mrla_tpu_torch.parallel.launch import (
    all_gather_metrics,
    all_reduce_sum,
    data_rank,
    data_size,
    global_mean,
    global_sum,
    init_distributed,
    initialized,
    is_main_process,
    rank,
    world_size,
)
from mrla_tpu_torch.parallel.mesh import (
    Mesh,
    average_gradients,
    batch_sharding,
    data_parallel,
    local_mesh,
    make_mesh,
    rank_device,
    replicated,
    shard_batch,
)
from mrla_tpu_torch.parallel.pipeline import (
    make_pipelined_vit,
    pipeline_shardings,
    stack_block_params,
    unstack_block_params,
)
from mrla_tpu_torch.parallel.sharding import (
    gather_state_dict,
    shard_train_state,
    tp_shardings,
)

__all__ = ["Mesh", "all_gather_metrics", "all_reduce_sum",
           "average_gradients", "batch_sharding", "data_parallel",
           "data_rank", "data_size", "gather_state_dict", "global_mean",
           "global_sum", "init_distributed", "initialized",
           "is_main_process", "local_mesh", "make_mesh",
           "make_pipelined_vit", "pipeline_shardings", "rank",
           "rank_device", "replicated", "shard_batch", "shard_train_state",
           "stack_block_params", "tp_shardings", "unstack_block_params",
           "world_size"]
