"""The fused MRLA-light train epilogue: one ``torch.autograd.Function`` for
a block's whole tail in training, with a hand-written backward.

    m    = dwconv3x3(out)·gate(out) + λ ⊙ identity     (out's dtype)
    ret  = out + BN_train(m)                           (batch statistics,
                                                        fp32)

It returns ``(ret, batch_mean, batch_var)``, the variance biased, for the
caller's running-statistic update.  NHWC at the API, as the JAX package's
``ops/fused_train.py``; the forward is the module path's math
(``MRLALightModule`` + ``BatchNorm2d`` in training).

The backward is the JAX op's VJP.  It saves only ``out``, ``identity``,
``v`` and the fp32 [B, C] / [C] vectors, and recomputes m from them; every
[B, H, W, C] reduction of the backward (dβ, dγ, dλ, the gate's) reads
(dret, m, v, identity).  The gate chain's gradient goes through an inner
autograd call; the depthwise conv's through autograd's own conv backward
(``aten.convolution_backward``), without running the conv's forward again.

Under data parallelism (a data group of more than one rank,
``parallel/launch.py:data_group``) the moments are the global batch's, as the module path's BN takes them
(``models/common.py:BatchNorm2d``): the forward all-reduces the per-channel
sum, sum of squares and count, and the backward the per-channel
reductions that its input gradient reads (dβ, dγ, and the cotangents of
the returned moments); dβ and dγ go back to DDP as this rank's own.

Plain PyTorch, as the JAX op is plain jax.numpy: the JAX package measured
no gain from it on its TPU and ships it off by default
(``ResNetMRLALight(fused_epilogue=True)``), and so does the port.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    global_avg_pool,
)
from mrla_tpu_torch.ops.mrla import MRLAParams, mrla_light_attention
from mrla_tpu_torch.parallel import launch

BN_EPS = 1e-5
_SUM = (0, 1, 2)


def _gate_from_gap(y: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """[B, C] fp32 GAP descriptor -> per-head sigmoid gate [B, heads]."""
    b, c = y.shape
    d = c // heads
    q = channel_conv1d(y, wq.float()).reshape(b, heads, d)
    k = channel_conv1d(y, wk.float()).reshape(b, heads, d)
    return torch.sigmoid((q * k).sum(-1) * (1.0 / math.sqrt(d)))


def _bn_affine(m: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(m - mean)·rsqrt(var + eps)·scale + bias in fp32, in m's dtype."""
    mul = torch.rsqrt(var + BN_EPS) * scale.float()
    return ((m.float() - mean) * mul + bias.float()).to(m.dtype)


def _stats(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    var, mean = torch.var_mean(m.float(), dim=_SUM, correction=0)
    return mean, var


def _global_stats(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            float]:
    """(mean, biased var, count) of the global batch; the batch's own
    (two-pass) at world 1."""
    n = float(m.numel() // m.shape[-1])
    if launch.data_size() == 1:
        return (*_stats(m), n)
    mf = m.float()
    c = m.shape[-1]
    sums = launch.global_sum(torch.cat([
        mf.sum(_SUM), (mf * mf).sum(_SUM),
        torch.full((1,), n, device=m.device)]))
    mean = sums[:c] / sums[-1]
    var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
    return mean, var, float(sums[-1])


class _FusedLightEpilogueTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, identity, wq, wk, wv, lam, scale, bias, heads):
        d = out.shape[-1] // heads
        y = global_avg_pool(out)
        gate = _gate_from_gap(y, wq, wk, heads).repeat_interleave(d, dim=-1)
        v = depthwise_conv3x3(out, wv)
        m = v * gate.to(v.dtype)[:, None, None, :] \
            + lam.to(identity.dtype) * identity
        mean, var, n = _global_stats(m)
        ret = out + _bn_affine(m, mean, var, scale, bias)
        ctx.heads, ctx.n = heads, n
        # a model's step reads mean and var for the running statistics
        # only: their cotangents are None then, and their terms are skipped
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out, identity, v, y, gate, mean, var, wq, wk,
                              wv, lam, scale)
        return ret, mean, var

    @staticmethod
    def backward(ctx, dret, dmean, dvar):
        (out, identity, v, y, gate, mean, var, wq, wk, wv, lam,
         scale) = ctx.saved_tensors
        heads, n = ctx.heads, ctx.n
        b, h, w, c = out.shape

        g32 = dret.float()
        rstd = torch.rsqrt(var + BN_EPS)
        # the BN input, recomputed from the saved maps exactly as forward
        m = v * gate.to(v.dtype)[:, None, None, :] \
            + lam.to(identity.dtype) * identity
        centred = m.float() - mean
        xhat = centred * rstd

        dbeta = g32.sum(_SUM)
        dgamma = (g32 * xhat).sum(_SUM)
        # the sums over the global batch that m's gradient reads; the
        # (mean, var) outputs are functions of the whole batch's m too
        sums = [dbeta, dgamma] + [d.float() for d in (dmean, dvar)
                                  if d is not None]
        sums = launch.global_sum(torch.cat(sums)).split(c)
        dm = (scale.float() * rstd) * (
            g32 - sums[0] / n - xhat * (sums[1] / n))
        rest = iter(sums[2:])
        if dmean is not None:
            dm = dm + next(rest) / n
        if dvar is not None:
            dm = dm + (2.0 / n) * next(rest) * centred

        dgate = (dm * v.float()).sum((1, 2))  # [B, C]
        dlam = (dm * identity.float()).sum(_SUM)
        did = (dm * lam.float()).to(identity.dtype)

        dv = (dm * gate[:, None, None, :]).to(v.dtype)
        dout_conv, dwv, _ = torch.ops.aten.convolution_backward(
            dv.permute(0, 3, 1, 2), out.permute(0, 3, 1, 2),
            wv.to(out.dtype), None, [1, 1], [1, 1], [1, 1], False, [0, 0],
            c, [True, True, False])

        dattn = dgate.reshape(b, heads, c // heads).sum(-1)  # [B, heads]
        with torch.enable_grad(), torch.autocast(y.device.type,
                                                 enabled=False):
            yq = y.detach().requires_grad_()
            q = wq.detach().requires_grad_()
            k = wk.detach().requires_grad_()
            dy, dwq, dwk = torch.autograd.grad(
                _gate_from_gap(yq, q, k, heads), (yq, q, k), dattn)

        # GAP backward: dy spread evenly over H·W
        dout = (g32 + dout_conv.permute(0, 2, 3, 1).float()
                + dy[:, None, None, :] / (h * w)).to(out.dtype)
        return (dout, did, dwq.to(wq.dtype), dwk.to(wk.dtype),
                dwv.to(wv.dtype), dlam.to(lam.dtype),
                dgamma.to(scale.dtype), dbeta.to(scale.dtype), None)


def fused_light_epilogue_train(out: torch.Tensor, identity: torch.Tensor,
                               wq: torch.Tensor, wk: torch.Tensor,
                               wv: torch.Tensor, lam: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor,
                               heads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """out, identity: [B, H, W, C]; wq, wk: k taps (any shape); wv:
    [C, 1, 3, 3]; lam, scale, bias: [C].  Returns (ret [B, H, W, C],
    batch_mean [C] fp32, batch_var [C] fp32 biased)."""
    with torch.autocast(out.device.type, enabled=False):
        return _FusedLightEpilogueTrain.apply(out, identity, wq, wk, wv, lam,
                                              scale, bias, heads)


def fused_epilogue_module_equivalent(out: torch.Tensor,
                                     identity: torch.Tensor,
                                     params: MRLAParams, lam: torch.Tensor,
                                     scale: torch.Tensor, bias: torch.Tensor,
                                     heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The same (ret, mean, var) through the module path's ops, for autograd
    to differentiate (the tests' reference)."""
    m = mrla_light_attention(out, params, heads) \
        + lam.to(identity.dtype) * identity
    mean, var = _stats(m)
    return out + _bn_affine(m, mean, var, scale, bias), mean, var
