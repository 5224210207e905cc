"""Data parallelism with ``torch.distributed``: NCCL on cards, gloo on
the CPU (and for ranks that share a card).  The JAX package's names carry
over where its functions do: ``init_distributed``, ``is_main_process``,
``all_gather_metrics`` (``launch.py``), ``shard_batch`` (``mesh.py``)."""

from mrla_tpu_torch.parallel.launch import (
    all_gather_metrics,
    all_reduce_sum,
    global_mean,
    global_sum,
    init_distributed,
    initialized,
    is_main_process,
    rank,
    world_size,
)
from mrla_tpu_torch.parallel.mesh import (
    data_parallel,
    rank_device,
    shard_batch,
)

__all__ = ["all_gather_metrics", "all_reduce_sum", "data_parallel",
           "global_mean", "global_sum", "init_distributed", "initialized",
           "is_main_process", "rank", "rank_device", "shard_batch",
           "world_size"]
