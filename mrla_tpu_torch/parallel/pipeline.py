"""Pipeline parallelism (the GPipe schedule) for the homogeneous-depth DeiT
family over a ``pipe`` axis: the port's counterpart of the JAX package's
``parallel/pipeline.py``.

The ``depth`` blocks are stacked along a leading axis
(:func:`stack_block_params`) and each ``pipe`` rank keeps its span of
``depth / S`` consecutive blocks (:func:`pipeline_shardings`, the JAX
``P('pipe')`` residency) beside the replicated rest: patch embed, cls /
dist / pos, the final norm and the head(s).

**Schedule.**  M microbatches run M + S - 1 ticks.  At tick t stage p
runs microbatch t - p through its span, if there is one (idle warm-up and
drain ticks compute nothing, where JAX computes and masks): stage 0 takes
it from the embedded tokens, every other stage from its predecessor, to
which the shift (``comm.send`` / ``comm.recv``) hands each output.  The
last stage's buffer of outputs is broadcast to every pipe rank, and the
final norm and head run alike on every stage.

**Gradients.**  The backward runs the schedule in reverse inside one
autograd ``Function``: microbatch by microbatch from the last, each stage
takes its output's cotangent (the last stage from the broadcast, the
others by the reverse shift from their successor), backpropagates its
span and hands its input's cotangent back.  The loss is replicated on the
pipe ranks, so the broadcast's backward keeps the last stage's own
cotangent (a sum over the stages would multiply by S:
``_GPipe.output_cotangent`` is where ``parallel/checks.py`` injects that
fault).  Only stage 0 consumes the
embedded tokens; their cotangent is summed over the pipe group, so patch
embed, cls and pos get the same gradient on every stage (and each stage
uses them: DDP needs no unused-parameter search).  Each rank walks the
same ticks in the same order, and an idle tick is idle on both sides of
each shift, so the collectives match one for one.

Scope, as the JAX module's: ``ViTMRLA`` with the light variant and the
plain (optionally distilled) ``VisionTransformer``, at drop rates 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from mrla_tpu_torch.parallel import comm
from mrla_tpu_torch.parallel.mesh import Axis, Mesh, batch_sharding

__all__ = ["stack_block_params", "unstack_block_params", "gpipe_spmd",
           "pipeline_shardings", "make_pipelined_vit"]

Params = Dict[str, torch.Tensor]


def _block_index(key: str, prefix: str) -> Optional[Tuple[int, str]]:
    if not key.startswith(prefix):
        return None
    head, _, rest = key[len(prefix):].partition(".")
    return (int(head), rest) if head.isdigit() and rest else None


def stack_block_params(params: Params, depth: int, prefix: str = "blocks."
                       ) -> Tuple[Params, Params]:
    """Split ordinary weights (``state_dict`` names) into (stacked
    ``{name in the block: [depth, ...]}``, rest).  Differentiable
    (``torch.stack``)."""
    per: Dict[int, Params] = {}
    rest = {}
    for k, v in params.items():
        hit = _block_index(k, prefix)
        if hit is None:
            rest[k] = v
        else:
            per.setdefault(hit[0], {})[hit[1]] = v
    if sorted(per) != list(range(depth)):
        raise ValueError(f"found {len(per)} '{prefix}*' trees, want {depth}")
    stacked = {k: torch.stack([per[i][k] for i in range(depth)])
               for k in per[0]}
    return stacked, rest


def unstack_block_params(stacked: Params, rest: Params,
                         prefix: str = "blocks.") -> Params:
    """Inverse of :func:`stack_block_params`."""
    out = dict(rest)
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        for k, v in stacked.items():
            out[f"{prefix}{i}.{k}"] = v[i]
    return out


def _span(axis: Axis, depth: int) -> slice:
    n = depth // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


def pipeline_shardings(mesh: Mesh, stacked: Params, axis: str = "pipe"
                       ) -> Params:
    """This rank's resident span of each stacked leaf (the leading axis
    split over ``axis``, as ``device_put`` with ``P(axis)`` stores it)."""
    ax = mesh.axis(axis)
    depth = next(iter(stacked.values())).shape[0]
    return {k: v[_span(ax, depth)].clone() for k, v in stacked.items()}


class _SpanOfWhole(torch.autograd.Function):
    """This stage's span of whole stacked leaves; the backward sums the
    spans' cotangents over the pipe group, so each rank holds the whole
    gradient, as the replicated JAX params get it."""

    @staticmethod
    def forward(ctx, axis, depth, *whole):
        ctx.axis, ctx.shapes = axis, [w.shape for w in whole]
        ctx.sl = _span(axis, depth)
        return tuple(w[ctx.sl] for w in whole)

    @staticmethod
    def backward(ctx, *grads):
        full = [g.new_zeros(s) for g, s in zip(grads, ctx.shapes)]
        for f, g in zip(full, grads):
            f[ctx.sl] = g
        flat = comm.all_reduce(torch.cat([f.reshape(-1) for f in full]),
                               ctx.axis)
        out = [p.view(s) for p, s in zip(
            flat.split([f.numel() for f in full]), ctx.shapes)]
        return (None, None, *out)


class _GPipe(torch.autograd.Function):
    """The schedule over one stage's span; see the module docstring."""

    @staticmethod
    def forward(ctx, run_span, m, axis, h, *leaves_in):
        p, s = axis.index, axis.size
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in leaves_in]
        mbs = h.reshape(m, h.shape[0] // m, *h.shape[1:])
        out = torch.zeros_like(mbs)
        ins, outs = {}, {}
        for t in range(m + s - 1):
            j = t - p
            if not 0 <= j < m:
                continue  # an idle tick: no compute, no shift
            x = (mbs[j] if p == 0
                 else comm.recv(torch.empty_like(mbs[j]), p - 1, axis))
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = run_span(leaves, x)
            ins[j], outs[j] = x, y
            if p < s - 1:
                comm.send(y.detach(), p + 1, axis)
            else:
                out[j] = y.detach()
        comm.broadcast(out, s - 1, axis)
        ctx.axis, ctx.m, ctx.leaves = axis, m, leaves
        ctx.ins, ctx.outs = ins, outs
        return out.reshape(h.shape)

    @staticmethod
    def output_cotangent(g, axis):
        """The broadcast's backward: the last stage's own cotangent (the
        loss is the same on every stage)."""
        return g

    @staticmethod
    def backward(ctx, g):
        axis, m, leaves = ctx.axis, ctx.m, ctx.leaves
        p, s = axis.index, axis.size
        g = _GPipe.output_cotangent(g.reshape(m, g.shape[0] // m,
                                              *g.shape[1:]), axis)
        dh = torch.zeros_like(g)
        want = [t for t in leaves if t.requires_grad]
        dl = [torch.zeros_like(t) for t in want]
        for j in reversed(range(m)):
            gy = (g[j] if p == s - 1
                  else comm.recv(torch.empty_like(g[j]), p + 1, axis))
            got = torch.autograd.grad(ctx.outs[j], [ctx.ins[j]] + want, gy,
                                      allow_unused=True)
            if p > 0:
                comm.send(got[0], p - 1, axis)
            else:
                dh[j] = got[0]
            for acc, d in zip(dl, got[1:]):
                if d is not None:
                    acc += d
        ctx.ins = ctx.outs = None
        dh = comm.all_reduce(dh, axis)  # stage 0's; the others hold zeros
        it = iter(dl)
        return (None, None, None, dh.reshape(-1, *dh.shape[2:]),
                *(next(it) if t.requires_grad else None for t in leaves))


def gpipe_spmd(run_span, span: Params, h: torch.Tensor,
               num_microbatches: int, axis: Axis) -> torch.Tensor:
    """The GPipe schedule: ``h`` [B, ...] in ``num_microbatches``
    microbatches through every stage's ``run_span(leaves, x)`` (this
    stage's leaves in ``span``'s order); returns the last stage's output
    [B, ...] on every rank of ``axis``."""
    return _GPipe.apply(run_span, num_microbatches, axis, h, *span.values())


def _drop_rates(model) -> Dict[str, float]:
    blocks = list(model.blocks)
    return {"drop_rate": model.drop_rate,
            "attn_drop_rate": max(b.attn.attn_drop.p for b in blocks),
            "drop_path_rate": max(b.drop_path for b in blocks)}


def make_pipelined_vit(model: nn.Module, mesh: Mesh, num_microbatches: int,
                       pipe_axis: str = "pipe",
                       data_axis: Optional[str] = None):
    """Pipeline-parallel forward of a ``ViTMRLA`` (light) or plain DeiT.

    Returns ``(forward, forward_from_stacked)``:

      ``forward(params, x, train=False)``: from ordinary weights
        (``state_dict`` names), stacked inside; the gradient of every block
        reaches every pipe rank, as JAX's replicated params get it;
      ``forward_from_stacked(span, rest, x, train=False)``: from the
        resident layout, ``span`` this rank's stacked blocks
        (:func:`pipeline_shardings`).

    ``x`` [B, H, W, 3] is the global batch; with ``data_axis`` each rank
    takes its rows of it and returns its rows of the logits, the batch
    split as ``shard_batch`` splits it.  A distilled model returns
    ``(logits, logits_dist)`` with ``train=True`` and their mean otherwise.
    ``model`` gives the structure only; its weights are not read.
    """
    from mrla_tpu_torch.models.deit import VisionTransformer
    from mrla_tpu_torch.models.deit_mrla import ViTMRLA

    if not isinstance(model, VisionTransformer):  # ViTMRLA is one
        raise TypeError(f"unsupported model for pipelining: "
                        f"{type(model).__name__} (need shape-homogeneous "
                        "'block{i}' stages)")
    for attr, rate in _drop_rates(model).items():
        if rate != 0.0:
            raise ValueError(
                f"pipelined forward is deterministic but model.{attr}={rate}"
                "; stochastic depth/dropout are not threaded through the "
                "GPipe schedule — construct the model with drop rates 0 to "
                "pipeline it (see module docstring)")
    if isinstance(model, ViTMRLA) and model.variant != "light":
        raise ValueError("mrlab's growing K/V cache crosses stage "
                         "boundaries with non-uniform shapes; pipeline the "
                         "light variant")
    ax = mesh.axis(pipe_axis)
    depth = len(model.blocks)
    if depth % ax.size:
        raise ValueError(f"depth {depth} % pipe {ax.size} != 0")
    m = num_microbatches
    template = model.blocks[0]
    distilled = model.distilled

    def run_span(keys):
        def run(leaves, x):
            for i in range(leaves[0].shape[0]):
                x = functional_call(template, {k: v[i] for k, v in
                                               zip(keys, leaves)}, (x,))
            return x
        return run

    def sub(rest: Params, prefix: str) -> Params:
        return {k[len(prefix):]: v for k, v in rest.items()
                if k.startswith(prefix)}

    def forward_from_stacked(span: Params, rest: Params, x: torch.Tensor,
                             train: bool = False):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} % microbatches {m} != 0")
        if data_axis is not None:
            x = x[batch_sharding(mesh, b, data_axis)]
            if x.shape[0] % m:
                raise ValueError(f"rows {x.shape[0]} a rank % microbatches "
                                 f"{m} != 0")
        pos = rest["pos_embed"]
        tokens = functional_call(model.patch_embed,
                                 sub(rest, "patch_embed."),
                                 (x.to(pos.dtype),))
        n = tokens.shape[0]
        parts = [rest["cls_token"].expand(n, -1, -1)]
        if distilled:
            parts.append(rest["dist_token"].expand(n, -1, -1))
        h = torch.cat(parts + [tokens], dim=1) + pos
        h = gpipe_spmd(run_span(list(span)), span, h, m, ax)
        h = functional_call(model.norm, sub(rest, "norm."),
                            (h[:, :len(parts)],))
        logits = functional_call(model.head, sub(rest, "head."),
                                 (h[:, 0],)).float()
        if not distilled:
            return logits
        logits_dist = functional_call(model.head_dist,
                                      sub(rest, "head_dist."),
                                      (h[:, 1],)).float()
        if train:
            return logits, logits_dist
        return (logits + logits_dist) / 2

    def forward(params: Params, x: torch.Tensor, train: bool = False):
        stacked, rest = stack_block_params(params, depth)
        keys = list(stacked)
        span = dict(zip(keys, _SpanOfWhole.apply(ax, depth,
                                                 *stacked.values())))
        return forward_from_stacked(span, rest, x, train)

    return forward, forward_from_stacked
