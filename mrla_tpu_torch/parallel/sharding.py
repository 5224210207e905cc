"""Output-channel tensor parallelism over the ``model`` axis: the port's
counterpart of the JAX package's ``parallel/sharding.py``.

**Which leaves.**  JAX's rule shards a leaf's last axis when the leaf has
two or more dims, that axis divides by the ``model`` size and the leaf has
at least ``min_elements`` elements.  Here the same axis is dim 0 of a conv
or linear weight (torch's output channels, JAX's last axis of HWIO /
``[in, out]``) and the last dim of any other parameter (the bridge carries
``pos_embed`` unpermuted).  Biases, norms, λ and 1-D taps stay whole.
:func:`tp_shardings` returns the plan, ``{state_dict key: dim or None}``.

**Storage.**  :func:`shard_train_state` keeps each ``model`` rank's
1/size of every sharded leaf, in the parameters, the optimizer's state and
the EMA, as the JAX function's ``device_put`` does.  ``state_dict`` keys and
``named_parameters`` names stay those of the whole model (the optimizer's
decay groups, the bridge and ``ckpt/io.py`` go by them);
:func:`gather_state_dict` returns the whole ``state_dict`` on every rank.

**Compute.**  An ``nn.Conv2d`` with ``groups == 1`` and an ``nn.Linear``
are column-parallel: each rank computes its output channels, then they are
all-gathered (``comm.all_gather``), so a rank does 1/size of the product,
as GSPMD does with output-sharded kernels; the bias is added to the whole
output.  Any other sharded leaf (a depthwise or grouped conv, ``pos_embed``)
is all-gathered where it is used: for the span of the outermost forward of
a module that reaches it (hooks on the leaf's owner and its ancestors, so a
recomputed block gathers it again).

**Gradients.**  The ``model`` ranks compute the same replicated loss, so
both gathers' backward takes this rank's slice of the cotangent (a sum
over the group would multiply by the size: ``_Gather.cotangent`` is where
``parallel/checks.py`` injects that fault).  The input of a
column-parallel product has its gradient all-reduced over the ``model``
group, each rank having seen only its channels.  DDP, BN and the
normalisers reduce over the data group (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch.parallel import comm
from mrla_tpu_torch.parallel.mesh import Axis, Mesh


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, t.shape[dim]
        return comm.all_gather(t, dim, axis)

    @staticmethod
    def cotangent(g, axis):
        """The whole output's cotangent: this rank's own, the loss being
        the same on every rank of the axis."""
        return g

    @staticmethod
    def backward(ctx, g):
        g = _Gather.cotangent(g, ctx.axis)
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n)
                .contiguous(), None, None)


class _CopyToModel(torch.autograd.Function):
    """The identity whose backward sums the cotangent over the group: the
    input of a column-parallel product."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.axis), None


def gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return t if axis.size == 1 else _Gather.apply(t, dim, axis)


class ColumnParallelConv2d(nn.Conv2d):
    """``nn.Conv2d`` (groups 1) holding this rank's output channels."""

    tp_axis: Axis

    def _conv_forward(self, x, weight, bias):
        x = _CopyToModel.apply(x, self.tp_axis)
        y = gather(super()._conv_forward(x, weight, None), 1, self.tp_axis)
        return y if bias is None else y + bias.view(1, -1, 1, 1).to(y.dtype)


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's output features."""

    tp_axis: Axis

    def forward(self, x):
        x = _CopyToModel.apply(x, self.tp_axis)
        y = gather(F.linear(x, self.weight), -1, self.tp_axis)
        return y if self.bias is None else y + self.bias.to(y.dtype)


_COLUMN_PARALLEL = {nn.Conv2d: ColumnParallelConv2d,
                    nn.Linear: ColumnParallelLinear}


class _GatherOnUse:
    """Swaps a sharded leaf for its gathered whole during the outermost
    forward of its owner or an ancestor (one instance per leaf, its hooks
    on each of those modules)."""

    def __init__(self, owner: nn.Module, name: str, dim: int, axis: Axis):
        self.owner, self.name, self.dim, self.axis = owner, name, dim, axis
        self.depth, self.shard = 0, None

    def pre(self, module, args):
        if self.depth == 0:
            self.shard = self.owner._parameters[self.name]
            self.owner._parameters[self.name] = gather(self.shard, self.dim,
                                                       self.axis)
        self.depth += 1

    def post(self, module, args, out):
        self.depth -= 1
        if self.depth == 0:
            self.owner._parameters[self.name] = self.shard
            self.shard = None

    def __deepcopy__(self, memo):
        raise TypeError("copy a model before it is made tensor-parallel")


def _owner(model: nn.Module, key: str):
    path, _, name = key.rpartition(".")
    return (model.get_submodule(path) if path else model), name


def _sharded_dim(owner: nn.Module, name: str, t: torch.Tensor) -> int:
    if name == "weight" and isinstance(owner, (nn.Conv2d, nn.Linear)):
        return 0
    return t.ndim - 1


def tp_shardings(model: nn.Module, mesh: Mesh, axis: str = "model",
                 min_elements: int = 1 << 16) -> Dict[str, Optional[int]]:
    """The plan ``{state_dict key: sharded dim or None}`` of a whole
    (unsharded) model: a parameter with two or more dims whose JAX-last dim
    divides by the axis size and with at least ``min_elements`` elements is
    sharded on that dim; buffers and every other parameter stay whole."""
    size = mesh.size(axis)
    params = dict(model.named_parameters())
    plan = {}
    for key, t in model.state_dict().items():
        plan[key] = None
        if size == 1 or key not in params or t.ndim < 2:
            continue
        dim = _sharded_dim(*_owner(model, key), t)
        if t.shape[dim] % size == 0 and t.numel() >= min_elements:
            plan[key] = dim
    return plan


def _slice(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n).clone()


def _tensor_parallel(model: nn.Module, mesh: Mesh,
                     plan: Dict[str, Optional[int]],
                     axis: str = "model") -> nn.Module:
    """Keep this rank's slice of each leaf ``plan`` shards (the same
    ``Parameter`` objects, so an optimizer built on them holds on) and make
    the model compute with the slices; returns ``model``."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return model
    model.tp_plan, model.tp_axis = dict(plan), ax
    ancestors: Dict[str, nn.Module] = dict(model.named_modules())
    for key, dim in plan.items():
        if dim is None:
            continue
        owner, name = _owner(model, key)
        p = owner._parameters[name]
        p.data = _slice(p.data, dim, ax)
        cls = _COLUMN_PARALLEL.get(type(owner))
        if (cls is not None and name == "weight" and dim == 0
                and getattr(owner, "groups", 1) == 1):
            owner.__class__, owner.tp_axis = cls, ax
            continue
        hook = _GatherOnUse(owner, name, dim, ax)
        path = key.rpartition(".")[0]
        parts = path.split(".") if path else []
        for i in range(len(parts) + 1):
            m = ancestors[".".join(parts[:i])]
            m.register_forward_pre_hook(hook.pre)
            m.register_forward_hook(hook.post, always_call=True)
    return model


def shard_train_state(state, mesh: Mesh, axis: str = "model",
                      min_elements: int = 1 << 16):
    """Apply the TP plan of ``state.model`` (a port ``TrainState``) to its
    parameters, the optimizer's state of each (its momenta) and the EMA;
    returns ``state``.  Every ``model`` rank must hold the same whole
    weights before; DDP (``state.ddp``) is built after."""
    if state.ddp is not None:
        raise ValueError("shard the train state before wrapping its model "
                         "in DDP (DDP records the parameters' shapes)")
    plan = tp_shardings(state.model, mesh, axis, min_elements)
    ax = mesh.axis(axis)
    if ax.size == 1:
        return state
    params = dict(state.model.named_parameters())
    for key, dim in plan.items():
        if dim is None:
            continue
        per = state.optimizer.state.get(params[key], {})
        for k, v in per.items():
            if torch.is_tensor(v) and v.shape == params[key].shape:
                per[k] = _slice(v, dim, ax)
    _tensor_parallel(state.model, mesh, plan, axis)
    if state.ema is not None:
        _tensor_parallel(state.ema, mesh, plan, axis)
    return state


@torch.no_grad()
def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a tensor-parallel model, on every rank
    of its ``model`` axis (the model's own ``state_dict`` when it is not
    tensor-parallel)."""
    sd = model.state_dict()
    plan = getattr(model, "tp_plan", None)
    if plan is None:
        return sd
    return {k: v if plan.get(k) is None
            else comm.all_gather(v, plan[k], model.tp_axis)
            for k, v in sd.items()}
