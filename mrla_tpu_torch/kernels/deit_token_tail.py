"""The DeiT MRLA-light token tail, residual included, as one call.

Counterpart of the JAX package's ``mrla_tpu/kernels/deit_token_tail.py``
(``deit_token_tail``), whose TPU kernel this module's CUDA kernel
(``csrc/deit_token_tail.cu``) replaces.  For tokens x (the block's output
after attention and MLP) and ot (the block's input), both [B, N, C] with
row 0 the cls token and rows 1.. an s x s grid (N = 1 + s * s, any s):

    normx = LN_x(x); normo = LN_o(ot)              eps 1e-6, fp32
    gap   = mean over the grid rows of normx       [B, C]
    q, k  = k-tap SAME cross-correlation of gap along C with wq, wk
    gate  = sigmoid(sum over each head's d channels of q * k / sqrt(d))
    v     = gelu(dwconv3x3(normx_grid))            exact erf, zero padding
    out_grid = x_grid + v * gate[head of c] + lam * normo_grid
    out_cls  = x_cls + normx_cls                   no MRLA term, no ot

that is ``x + MRLALightTokenModule(x, ot)``.  Everything is fp32 inside;
the result is rounded once to the dtype of x.

``pack_tail_params`` lays a block's tail weights out as the kernel reads
them: ``TailParams(vec, taps)`` with ``vec`` [14, C] fp32 (rows 0, 1 the
weight and bias of LN_x; 2, 3 of LN_o; 4 lam; 5..13 the depthwise taps, row
``5 + (dh + 1) * 3 + (dw + 1)`` from the [C, 1, 3, 3] weight's
``[c, 0, dh + 1, dw + 1]``) and ``taps`` [2, k] fp32 (wq, wk).

``deit_token_tail`` launches the kernel for CUDA tensors (bf16) and runs the
plain version ``deit_token_tail_reference`` only for CPU tensors; any other
input raises.  The kernel takes C % 32 == 0, C <= 1024, C % dim_perhead == 0,
an odd k and a square grid of at most 29 x 29 tokens; its C entry point returns
cudaErrorInvalidValue (1) for anything else, and the wrapper raises.
``deit_token_tail.counter`` counts calls and launches, the launches also by
(B, N, C).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import (
    check_cuda_args,
    use_plain_version,
)
from mrla_tpu_torch.ops.common import channel_conv1d, depthwise_conv3x3

LN_EPS = 1e-6


class TailParams(NamedTuple):
    """One block's tail weights as the kernel reads them (module docstring)."""

    vec: torch.Tensor   # [14, C] fp32
    taps: torch.Tensor  # [2, k] fp32


def pack_tail_params(sd: Mapping[str, torch.Tensor], prefix: str = "",
                     device="cpu") -> TailParams:
    """Pack the tail of one ``MRLALightTokenModule`` from its ``state_dict``
    entries ``{prefix}normx.{weight,bias}``, ``{prefix}normo.{weight,bias}``,
    ``{prefix}lambda_t`` and ``{prefix}mrla.W{q,k,v}.weight``."""
    get = lambda name: sd[prefix + name].detach().to("cpu", torch.float32)
    wv = get("mrla.Wv.weight")  # [C, 1, 3, 3]
    c = wv.shape[0]
    rows = [get("normx.weight"), get("normx.bias"), get("normo.weight"),
            get("normo.bias"), get("lambda_t").reshape(-1)]
    vec = torch.cat([torch.stack(rows), wv.reshape(c, 9).t()])
    taps = torch.stack([get("mrla.Wq.weight").reshape(-1),
                        get("mrla.Wk.weight").reshape(-1)])
    return TailParams(vec.contiguous().to(device),
                      taps.contiguous().to(device))


def _grid_side(n: int) -> int:
    s = math.isqrt(max(n - 1, 0))
    if n < 2 or s * s != n - 1:
        raise ValueError(f"token count {n} is not 1 + a square")
    return s


def _check_args(x, ot, packed: TailParams, dim_perhead: int):
    if x.dim() != 3 or ot.shape != x.shape:
        raise ValueError(f"x and ot must both be [B, N, C], got "
                         f"{tuple(x.shape)} and {tuple(ot.shape)}")
    b, n, c = x.shape
    _grid_side(n)
    if tuple(packed.vec.shape) != (14, c):
        raise ValueError(f"vec must be (14, {c}), got "
                         f"{tuple(packed.vec.shape)}")
    if packed.taps.dim() != 2 or packed.taps.shape[0] != 2:
        raise ValueError(f"taps must be (2, k), got "
                         f"{tuple(packed.taps.shape)}")
    if dim_perhead <= 0 or c % dim_perhead:
        raise ValueError(f"C = {c} is not a multiple of dim_perhead = "
                         f"{dim_perhead}")
    return b, n, c


def _layer_norm(v: torch.Tensor, weight, bias) -> torch.Tensor:
    mean = v.mean(-1, keepdim=True)
    d = v - mean
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + LN_EPS) * weight + bias


def tail_terms(x, ot, packed: TailParams, dim_perhead: int = 16):
    """The fp32 terms the tail is assembled from: ``(x32, normx, normo,
    gate, v)`` with normx, normo [B, N, C], gate [B, C] and v [B, N - 1, C]
    (the activated depthwise value of the grid rows)."""
    b, n, c = _check_args(x, ot, packed, dim_perhead)
    s = _grid_side(n)
    heads = c // dim_perhead
    vec, taps = packed.vec.float(), packed.taps.float()
    x32 = x.float()
    normx = _layer_norm(x32, vec[0], vec[1])
    normo = _layer_norm(ot.float(), vec[2], vec[3])
    grid = normx[:, 1:]
    gap = grid.mean(1)
    q = channel_conv1d(gap, taps[0]).reshape(b, heads, dim_perhead)
    k = channel_conv1d(gap, taps[1]).reshape(b, heads, dim_perhead)
    attn = torch.sigmoid((q * k).sum(-1) / math.sqrt(dim_perhead))
    gate = attn.repeat_interleave(dim_perhead, dim=-1)
    wv = vec[5:14].t().reshape(c, 1, 3, 3)
    v = F.gelu(depthwise_conv3x3(grid.reshape(b, s, s, c), wv))
    return x32, normx, normo, gate, v.reshape(b, n - 1, c)


def deit_token_tail_reference(x, ot, packed: TailParams,
                              dim_perhead: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: any batch, any square grid, fp32
    inside, one rounding to the dtype of x."""
    x32, normx, normo, gate, v = tail_terms(x, ot, packed, dim_perhead)
    lam = packed.vec[4].float()
    grid = x32[:, 1:] + v * gate[:, None, :] + lam * normo[:, 1:]
    cls = x32[:, :1] + normx[:, :1]
    return torch.cat([cls, grid], dim=1).to(x.dtype)


def deit_token_tail(x: torch.Tensor, ot: torch.Tensor, packed: TailParams,
                    dim_perhead: int = 16) -> torch.Tensor:
    """``x + MRLALightTokenModule(x, ot)`` as a new [B, N, C] tensor like x."""
    counter = deit_token_tail.counter
    counter.calls += 1
    b, n, c = _check_args(x, ot, packed, dim_perhead)
    if use_plain_version(x):
        return deit_token_tail_reference(x, ot, packed, dim_perhead)
    check_cuda_args({"x": x, "ot": ot},
                    {"vec": packed.vec, "taps": packed.taps})
    ktap = packed.taps.shape[1]
    lib = library()
    # scratch: the gate and the rows' statistics; the size is -1 for a
    # shape the kernel does not take, which the launch below then refuses
    # itself
    per_image = lib.deit_token_tail_scratch_per_image(n, c, dim_perhead, ktap)
    scratch = torch.empty(b * max(per_image, 0), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.deit_token_tail_bf16(
            x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b, n, c, dim_perhead, ktap,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"deit_token_tail_bf16 (N={n}, C={c}, d={dim_perhead}, "
               f"k={ktap})")
    counter.launch((b, n, c))
    return out


deit_token_tail.counter = LaunchCounter()
