"""The mesh of the joined ranks and the data-parallel placement: the port's
counterpart of the JAX package's ``parallel/mesh.py``.

:func:`make_mesh` lays the ranks out on named axes as JAX lays out its
devices (``np.asarray(devices).reshape(shape)``: rank = d·M + m on a
``("data", "model")`` mesh of shape (D, M)) and builds one process group
for each slice of each axis.  ``with mesh:`` makes it the mesh the
data-parallel collectives read (``parallel/launch.py:data_group``): BN's
moments, the loss normalisers, the logged metrics and DDP then reduce over
this rank's slice of the ``data`` axis only.  With no mesh entered the data
group is the world, the one-axis case.

Where the JAX trainer assembles one global array from each process's rows
(``make_array_from_process_local_data``), a rank here keeps its own
contiguous rows of the global batch (:func:`shard_batch`,
:func:`batch_sharding`: rows by the rank's index on the data axis) and its
model is wrapped in DDP over the data group (:func:`data_parallel`), which
averages the gradients.  The tensor-parallel (``sharding.py``) and pipeline
(``pipeline.py``) layers use the ``model`` and ``pipe`` groups.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.parallel import launch
from mrla_tpu_torch.parallel.launch import (
    initialized,
    local_rank,
    rank,
    world_size,
)


class Axis:
    """One axis of a mesh as this rank sees it: its slice's process group
    (None at size 1), its size, this rank's index and the slice's global
    ranks.  A deep copy is the same object (a module that holds one can be
    copied)."""

    def __init__(self, group: Optional[dist.ProcessGroup],
                 ranks: Sequence[int], index: int,
                 pairs: Optional[Dict[int, dist.ProcessGroup]] = None):
        self.group, self.ranks, self.index = group, list(ranks), index
        self.size = len(self.ranks)
        self.pairs = pairs or {}

    def pair(self, i: int) -> Optional[dist.ProcessGroup]:
        """The group of positions i and i + 1 of this slice (built for a
        gloo mesh: the pipeline's shift as broadcasts)."""
        return self.group if self.size == 2 else self.pairs[i]

    def __deepcopy__(self, memo):
        return self


class Mesh:
    """Named axes over the joined ranks (``grid``: their global ranks in
    mesh layout); ``with mesh:`` makes it the mesh of the data-parallel
    collectives.  ``shape`` maps each axis to its size."""

    def __init__(self, axes: Sequence[str], grid: np.ndarray,
                 axis: Mapping[str, Axis]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self._axis = dict(axis)

    def axis(self, name: str) -> Axis:
        """The axis ``name``; an axis the mesh does not have is one rank,
        this one."""
        if name not in self._axis:
            return Axis(None, [rank()], 0)
        return self._axis[name]

    def group(self, name: str) -> Optional[dist.ProcessGroup]:
        return self.axis(name).group

    def size(self, name: str) -> int:
        return self.axis(name).size

    def index(self, name: str) -> int:
        return self.axis(name).index

    def __enter__(self) -> "Mesh":
        launch._MESHES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        launch._MESHES.remove(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _slices(grid: np.ndarray, i: int) -> List[List[int]]:
    """The global ranks of every slice along axis ``i``, in a fixed order."""
    moved = np.moveaxis(grid, i, -1)
    return [list(map(int, row)) for row in moved.reshape(-1, grid.shape[i])]


def make_mesh(axes: Sequence[str] = ("data", "model"),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the joined ranks (one rank when no group is joined).
    Default: every rank on the first axis, the others of size 1.  Every
    rank must call it with the same arguments: it builds a process group
    for each slice of each axis of size > 1 (on gloo, also one for each
    neighbouring pair of an axis longer than 2)."""
    n, me = world_size(), rank()
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    shape = [int(v) for v in shape]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    grid = np.arange(n).reshape(shape)
    pairs_too = initialized() and dist.get_backend() == "gloo"
    axis = {}
    for i, name in enumerate(axes):
        for row in _slices(grid, i):
            group, pairs = None, {}
            if len(row) > 1:
                group = (dist.group.WORLD if len(row) == n
                         else dist.new_group(row))
            if pairs_too and len(row) > 2:
                for j in range(len(row) - 1):
                    pairs[j] = dist.new_group(row[j:j + 2])
            if me in row:
                axis[name] = Axis(group, row, row.index(me), pairs)
    return Mesh(axes, grid, axis)


def local_mesh() -> Mesh:
    """The one-rank mesh: this rank alone on ``("data", "model")``."""
    me = rank()
    return Mesh(("data", "model"), np.array([[me]]),
                {"data": Axis(None, [me], 0), "model": Axis(None, [me], 0)})


def batch_sharding(mesh: Mesh, n: int, axis: str = "data") -> slice:
    """This rank's contiguous rows of a global batch of ``n`` (the batch
    split over ``axis``; rows [i·n/D, (i + 1)·n/D) at index i of D)."""
    size, i = mesh.size(axis), mesh.index(axis)
    if n % size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{size} ranks of {axis!r}")
    k = n // size
    return slice(i * k, (i + 1) * k)


def replicated(mesh: Mesh) -> slice:
    """Every row: the whole batch on every rank."""
    return slice(None)


def shard_batch(batch: Mapping, rank_: Optional[int] = None,
                world: Optional[int] = None) -> dict:
    """This rank's contiguous rows of a global batch (a mapping of arrays or
    tensors with the batch first): rows ``[r·n, (r + 1)·n)``, n = B /
    world, r and world by default this rank's index on the data axis and
    its size (the entered mesh's, else the world's).  The batch must
    divide by the world."""
    rank_ = launch.data_rank() if rank_ is None else rank_
    world = launch.data_size() if world is None else world
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
    """``module`` wrapped in DDP on ``device`` over the data group when a
    process group is joined (at any world size), else ``module`` itself;
    inside ``with mesh:`` a data axis of one rank needs no DDP.  Checkpoints
    and the EMA keep the unwrapped module's state_dict."""
    if not initialized():
        return module
    group, size = launch.data_group()
    if launch.active_mesh() is not None and size == 1:
        return module
    device = torch.device(device)
    ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(module, device_ids=ids,
                                               process_group=group)


def average_gradients(tensors) -> None:
    """DDP's reduction for tensors outside a module (the pipeline's
    resident layout): each ``.grad`` averaged over the data group, in one
    flat all-reduce."""
    group, size = launch.data_group()
    grads = [t.grad for t in tensors if t.grad is not None]
    if size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
