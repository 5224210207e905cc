"""The collectives of the model and pipeline axes, built from what the
group's backend carries.

NCCL carries everything, and gloo carries CPU tensors everywhere; gloo
carries CUDA tensors for all-reduce and broadcast only.  So:

  * :func:`all_gather` (along a dim): ``all_gather_into_tensor`` where the
    backend carries it, else an all-reduce of a zero-filled buffer that
    holds this rank's slice (adding zeros is exact);
  * :func:`send` / :func:`recv` between neighbours of an axis:
    ``batch_isend_irecv`` where the backend carries it, else a broadcast
    from the sender over the pair's own group (``mesh.Axis.pair``).

Nothing is copied to the host on the way: a CUDA tensor stays on the card
on either backend.  ``NATIVE`` set to False takes the all-reduce and
broadcast forms on any backend (the tests hold the two forms bitwise equal
on the CPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mrla_tpu_torch.parallel.mesh import Axis

NATIVE = True

_all_gather_tensor = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def native(group, t: torch.Tensor) -> bool:
    """Whether the group's backend carries all-gather and point-to-point
    for ``t``."""
    return NATIVE and (dist.get_backend(group) == "nccl" or not t.is_cuda)


def all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis' slices of ``t`` (equal shapes) concatenated along ``dim``
    in index order."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    if native(axis.group, t):
        buf = t.new_empty((axis.size * t.shape[0], *t.shape[1:]))
        _all_gather_tensor(buf, t, group=axis.group)
        buf = buf.view(axis.size, *t.shape)
    else:
        buf = t.new_zeros((axis.size, *t.shape))
        buf[axis.index] = t
        dist.all_reduce(buf, group=axis.group)
    return torch.cat(buf.unbind(0), dim)


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` summed over the axis (a new tensor)."""
    t = t.clone()
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def broadcast(t: torch.Tensor, src: int, axis: Axis) -> torch.Tensor:
    """The tensor of the rank at index ``src`` on every rank of the axis
    (``t`` is overwritten elsewhere)."""
    if axis.size > 1:
        dist.broadcast(t, axis.ranks[src], group=axis.group)
    return t


def send(t: torch.Tensor, to: int, axis: Axis) -> None:
    """Hand ``t`` to the neighbour at index ``to`` (this index ± 1), which
    calls :func:`recv` with a buffer of its shape."""
    t = t.contiguous()
    if native(axis.group, t):
        op = dist.P2POp(dist.isend, t, axis.ranks[to], group=axis.group)
        for work in dist.batch_isend_irecv([op]):
            work.wait()
    else:
        dist.broadcast(t, axis.ranks[axis.index],
                       group=axis.pair(min(to, axis.index)))


def recv(buf: torch.Tensor, frm: int, axis: Axis) -> torch.Tensor:
    """What the neighbour at index ``frm`` sends, into ``buf``."""
    if native(axis.group, buf):
        op = dist.P2POp(dist.irecv, buf, axis.ranks[frm], group=axis.group)
        for work in dist.batch_isend_irecv([op]):
            work.wait()
    else:
        dist.broadcast(buf, axis.ranks[frm],
                       group=axis.pair(min(frm, axis.index)))
    return buf
