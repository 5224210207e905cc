"""Data-parallel placement: the port's counterpart of the JAX package's
``parallel/mesh.py`` for its one strategy, DP (the reference's only one,
SURVEY.md §2.4).

Where the JAX trainer assembles one global array from each process's rows
(``make_array_from_process_local_data``, ``mesh.py:45-68``), a rank here
keeps its own contiguous rows of the global batch (:func:`shard_batch`) and
its model is wrapped in DDP (:func:`data_parallel`), which averages the
gradients over the ranks.  BN normalises over the global batch
(``models/common.py:BatchNorm2d``), as the JAX step's does under GSPMD.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.parallel.launch import (
    initialized,
    local_rank,
    rank,
    world_size,
)


def shard_batch(batch: Mapping, rank_: Optional[int] = None,
                world: Optional[int] = None) -> dict:
    """This rank's contiguous rows of a global batch (a mapping of arrays or
    tensors with the batch first): rows ``[r·n, (r + 1)·n)``, n = B /
    world.  The batch must divide by the world."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    out = {}
    for k, v in batch.items():
        if len(v) % world:
            raise ValueError(f"a global batch of {len(v)} ({k!r}) does not "
                             f"divide over {world} ranks")
        n = len(v) // world
        out[k] = v[rank_ * n:(rank_ + 1) * n]
    return out


def rank_device(device) -> torch.device:
    """The rank's device: ``cuda`` becomes ``cuda:LOCAL_RANK``, which must
    exist (no rank shares a card or drops to the CPU on its own); any other
    device stays as it is."""
    dev = resolve_device(device)
    if dev.type != "cuda" or not initialized():
        return dev
    lr = local_rank()
    if lr >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {rank()} has LOCAL_RANK {lr}, but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible: NCCL "
            "needs one card a rank")
    return torch.device("cuda", lr)


def data_parallel(module: nn.Module, device) -> nn.Module:
    """``module`` wrapped in DDP on ``device`` when a process group is
    joined (at any world size), else ``module`` itself.  Checkpoints and the
    EMA keep the unwrapped module's state_dict."""
    if not initialized():
        return module
    device = torch.device(device)
    ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(module, device_ids=ids)
