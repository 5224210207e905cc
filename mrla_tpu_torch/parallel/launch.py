"""Process-group launch, the collectives of the data-parallel path, and
metric sync: the port's counterpart of the JAX package's
``parallel/launch.py``.

The launch environment is torchrun's, the reference's own scheme
(deit/utils.py:216-238): ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.  :func:`init_distributed` joins the
process group it describes, with ``nccl`` for a CUDA device and ``gloo`` for
the CPU unless the caller names a backend; without that environment (and
with no group already joined) it is a no-op, and the process is rank 0 of a
world of 1.  A group the caller joined itself, by any init method, is used
as it is.

NCCL takes one card a rank.  Two ranks can share one card over ``gloo``,
which all-reduces and broadcasts CUDA tensors: the data-parallel training
path uses those two collectives only (:func:`global_sum`,
:func:`all_reduce_sum` and DDP's own), so it runs on either backend.

The data-parallel collectives reduce over the **data group**: the ranks
that hold different rows of the global batch.  With no mesh entered that
is the world, as before; inside ``with mesh:`` (``parallel/mesh.py``) it is
this rank's slice of the mesh's ``data`` axis, so the ranks of a ``model``
or ``pipe`` axis, which hold the same rows, are never summed together.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from mrla_tpu_torch._device import resolve_device

LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK")


# the meshes entered (``with mesh:``), innermost last
_MESHES: List = []


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def active_mesh():
    """The innermost mesh entered, or None."""
    return _MESHES[-1] if _MESHES else None


def data_group() -> Tuple[Optional[dist.ProcessGroup], int]:
    """(group, size) of the data-parallel collectives: the world (group
    None) with no mesh entered, else this rank's slice of the mesh's
    ``data`` axis (size 1 when the mesh has none)."""
    mesh = active_mesh()
    if mesh is None:
        return None, world_size()
    return mesh.group("data"), mesh.size("data")


def data_size() -> int:
    """The ranks that hold different rows of the global batch."""
    return data_group()[1]


def data_rank() -> int:
    """This rank's index among them (its rows of the global batch)."""
    mesh = active_mesh()
    return rank() if mesh is None else mesh.index("data")


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    """The rank among this host's processes (``LOCAL_RANK``), which picks
    the rank's card; 0 without a launch environment."""
    return int(os.environ.get("LOCAL_RANK", "0")) if initialized() else 0


def launched() -> bool:
    """Whether the process was started with a launch environment."""
    return all(k in os.environ for k in LAUNCH_ENV)


def init_distributed(backend: Optional[str] = None,
                     device="cuda") -> Dict[str, int]:
    """Join the process group of the launch environment, if there is one
    and no group is joined yet; returns the JAX function's keys
    (``process_index``, ``process_count``, ``local_devices``: one device a
    rank, ``global_devices``).  ``device`` is the rank's device, the card
    by default, as every entry point's: joining a group without a card
    raises (``resolve_device``) unless the caller passes ``device="cpu"``.
    ``backend`` defaults to ``nccl`` for a CUDA device and ``gloo`` for the
    CPU."""
    if not initialized() and launched():
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": 1, "global_devices": world_size()}


def is_main_process() -> bool:
    """The rank-0 gate for checkpoints, logs and artefacts (the
    reference's save_on_master, deit/utils.py:172-213)."""
    return rank() == 0


def _comm_device(like: Optional[torch.Tensor] = None,
                 group: Optional[dist.ProcessGroup] = None) -> torch.device:
    """Where a collective's tensor must live: NCCL's on the rank's card,
    gloo's where it already is (the CPU for host values)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return like.device if like is not None else torch.device("cpu")


def all_gather_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Scalar metrics summed over the data group (the reference's
    all_reduce of its meters, deit/utils.py:36-47; the JAX function's
    sum)."""
    group, size = data_group()
    if size == 1:
        return metrics
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys],
                       dtype=torch.float64,
                       device=_comm_device(group=group))
    dist.all_reduce(vec, group=group)
    return dict(zip(keys, vec.tolist()))


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, with no gradient: a batch-level
    count (a loss's normaliser) of the global batch.  ``t`` itself when
    the group is one rank."""
    group, size = data_group()
    if size == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the data group, with no gradient (a logged
    loss)."""
    size = data_size()
    if size == 1:
        return t
    return global_sum(t) / size


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the cotangent over the group:
    each rank's input then gets the gradient of the sum of every rank's
    loss through the global value."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None, size: int = 0
                   ) -> torch.Tensor:
    """Differentiable sum over ``group`` of ``size`` ranks (by default the
    data group); ``t`` itself when the group is one rank."""
    if not size:
        group, size = data_group()
    if size == 1:
        return t
    return _AllReduceSum.apply(t, group)
