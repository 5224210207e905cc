"""int8 post-training-quantized resnet_mrlal serving engine: the port's
counterpart of the JAX package's ``serving/quant.py``.

The scheme is the JAX package's (symmetric PTQ):
  * conv kernels, BN-folded by ``prepare_inference_params``, are int8 per
    output channel, scale sw[c] = absmax / 127;
  * activations have per-tensor static scales calibrated from one bf16
    forward (the absmax at each quant point, or a percentile of |t|);
  * each conv is an exact int8 x int8 -> int32 product, then one fp32
    dequantisation ``acc * m + b`` with m[c] = s_in · sw[c];
  * ``quant_residual=True`` carries the residual stream int8 between
    blocks; the default (False) keeps it bf16 and quantises only the conv
    inputs, the accuracy-safe form;
  * the MRLA epilogue stays bf16 and runs the port's epilogue kernel
    (``kernels/mrla_epilogue.py``, row 1 of the kernel table) on the card,
    its plain version on the CPU; ``quant_epilogue=True`` carries the
    epilogue's stream int8 instead (an exact integer GAP, an int8
    depthwise Wv), in plain PyTorch as in the JAX package;
  * the stem and the head stay bf16 / fp32.

Integer products.  An s8 x s8 sum over 2,048 channels reaches
2,048 · 127² ≈ 3.3e7 > 2²⁴, so fp32 or bf16 emulation would round: every
int8 convolution runs through ``torch._int_mm`` (int8 x int8 -> int32;
cuBLASLt on the card; the JAX package computes these convolutions outside
any Pallas kernel too).  A 1x1 conv is one product over the channels (a
strided one subsamples first); a 3x3 conv is an int8 im2col (nine
shifted, zero-padded views concatenated over the channels, the stride
applied) times the kernel laid out [Cout, 9 · Cin] in (dy, dx, cin) order.
On the card ``_int_mm`` takes M > 16 rows and K, N multiples of 8, which
every ResNet width meets; anything else raises (no fallback).

Chains: the stem and its quantisation run on the whole batch, then
``microbatch``-image chains (64 by default, the JAX engine's), and the
head takes the chains' maps together (``serving/microbatch.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.kernels.mrla_epilogue import (
    mrla_light_epilogue,
    mrla_light_epilogue_reference,
)
from mrla_tpu_torch.ops.common import channel_conv1d
from mrla_tpu_torch.serving.microbatch import chains
from mrla_tpu_torch.serving.resnet_mrlal import (
    _check_device,
    _conv,
    _stem,
    prepare_inference_params,
)


def _strides_for(layers: Sequence[int]):
    strides = []
    stage_last = []
    for stage_idx, blocks in enumerate(layers):
        for block_idx in range(blocks):
            strides.append(2 if (stage_idx > 0 and block_idx == 0) else 1)
        stage_last.append(len(strides) - 1)
    return strides, stage_last


def _percentile(t: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(t.reshape(-1), q)`` (linear interpolation between
    the two order statistics around q / 100 · (n - 1)), by ``kthvalue``:
    ``torch.quantile`` refuses inputs over 2²⁴ elements."""
    flat = t.reshape(-1)
    pos = q / 100.0 * (flat.numel() - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, flat.numel() - 1)
    w = pos - lo
    v_lo = torch.kthvalue(flat, lo + 1).values
    v_hi = torch.kthvalue(flat, hi + 1).values
    return v_lo * (1.0 - w) + v_hi * w


@torch.inference_mode()
def _calib_absmax(sp: Dict, x: torch.Tensor, layers: Sequence[int],
                  dim_perhead: int, percentile: float = 100.0):
    """bf16 forward collecting the range at every quant point (the absmax,
    or the given percentile of |t|), with the plain epilogue as the JAX
    function has it.  Returns (stem range, per-block [out1, out2, out_act,
    y] ranges [n_blocks, 4]), fp32."""

    def rng_of(t):
        a = t.float().abs()
        return (a.amax() if percentile >= 100.0
                else _percentile(a, percentile))

    strides, _ = _strides_for(layers)
    y = _stem(x.to(sp["stem"]["k"].dtype), sp["stem"])
    stem_am = rng_of(y)
    rows = []
    for p, stride in zip(sp["blocks"], strides):
        heads = p["lam"].shape[0] // dim_perhead
        out1 = _conv(y, p["k1"], p["b1"]).relu()
        out2 = _conv(out1, p["k2"], p["b2"], stride=stride).relu()
        z = _conv(out2, p["k3"], p["b3"])
        identity = (_conv(y, p["kd"], p["bd"], stride=stride)
                    if "kd" in p else y)
        out = (z + identity).relu()
        y = mrla_light_epilogue_reference(
            out, identity, p["wq"], p["wk"], p["wv"], p["lam"],
            p["bn_scale"], p["bn_bias"], heads)
        rows.append(torch.stack([rng_of(out1), rng_of(out2), rng_of(out),
                                 rng_of(y)]))
    return stem_am, torch.stack(rows)


def _quant_kernel(k: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW kernel: (kq [Cout,
    kh · kw · Cin] int8 in (dy, dx, cin) order, sw [Cout] fp32)."""
    k = k.detach().to("cpu", torch.float32)
    sw = k.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    kq = torch.round(k / sw[:, None, None, None]).clamp_(-127, 127)
    kq = kq.to(torch.int8).permute(0, 2, 3, 1)  # [O, kh, kw, I]
    return kq.reshape(kq.shape[0], -1).contiguous(), sw


def _scalar(v: float, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def prepare_quant_params(
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    calib_x,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 32,
    percentile: float = 100.0,
    device="cuda",
) -> Dict:
    """The int8 serving params on ``device``, from a resnet_mrlal model or
    state_dict and a calibration batch ``calib_x`` [B, H, W, 3] (normalised
    images, numpy or a tensor; any batch size).  Scales are fp32 scalars in
    the tree; ``percentile`` < 100 clips the calibration (outlier-robust)."""
    dev = resolve_device(device)
    sp = prepare_inference_params(model_or_state_dict, layers=layers,
                                  dtype=torch.bfloat16, device=dev, s2d=False)
    x = torch.as_tensor(np.asarray(calib_x) if not torch.is_tensor(calib_x)
                        else calib_x).to(dev, torch.float32)
    stem_am, rows = _calib_absmax(sp, x, tuple(layers), dim_perhead,
                                  percentile)
    stem_am = np.float32(stem_am.item())
    rows = rows.cpu().numpy().astype(np.float32)
    a_stem = float(max(stem_am, 1e-6)) / 127.0

    out: Dict[str, Any] = {"stem": sp["stem"], "fc": sp["fc"], "blocks": [],
                           "inv_a_stem": _scalar(1.0 / a_stem, dev)}
    a_in = a_stem
    for i, p in enumerate(sp["blocks"]):
        a1, a2, ao, ay = (float(max(r, 1e-6)) / 127.0 for r in rows[i])
        blk: Dict[str, Any] = {}
        convs = [("1", a_in), ("2", a1), ("3", a2)]
        if "kd" in p:
            convs.append(("d", a_in))
        for ci, s_in in convs:
            kq, sw = _quant_kernel(p[f"k{ci}"])
            blk[f"k{ci}q"] = kq.to(dev)
            # s_in rounded to fp32 first, as numpy's weak python scalar is
            blk[f"m{ci}"] = (torch.tensor(s_in, dtype=torch.float32)
                             * sw).to(dev)
            blk[f"b{ci}"] = p[f"b{ci}"].float()
        # the int8 epilogue's extras: the depthwise Wv per channel over its
        # nine taps, and the out_act scale
        wv = p["wv"].to("cpu", torch.float32)  # [9, C]
        sv = wv.abs().amax(0).clamp_min(1e-12) / 127.0
        blk["wvq"] = torch.round(wv / sv).clamp_(-127, 127).to(
            torch.int8).to(dev)
        blk["mv"] = (torch.tensor(ao, dtype=torch.float32) * sv).to(dev)
        blk["a_in"] = _scalar(a_in, dev)
        blk["a_out"] = _scalar(ao, dev)
        blk["inv_a1"] = _scalar(1.0 / a1, dev)
        blk["inv_a2"] = _scalar(1.0 / a2, dev)
        blk["inv_a_out"] = _scalar(1.0 / ao, dev)
        blk["inv_ay"] = _scalar(1.0 / ay, dev)
        for name in ("wq", "wk", "wv", "lam", "bn_scale", "bn_bias"):
            blk[name] = p[name]
        out["blocks"].append(blk)
        a_in = ay
    return out


def _quant(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip, then cast (``jnp.round`` and
    ``torch.round`` both round half to even)."""
    return (x.float() * inv_scale).round_().clamp_(-127.0, 127.0).to(
        torch.int8)


def _int_mm(a: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 x kq [N, K] int8 -> [M, N] int32, exact."""
    m, k = a.shape
    n = kq.shape[0]
    if a.device.type == "cuda" and not (m > 16 and k % 8 == 0
                                        and n % 8 == 0):
        raise ValueError(
            f"int8 product [{m}, {k}] x [{k}, {n}]: torch._int_mm on CUDA "
            "takes M > 16 and K, N multiples of 8")
    return torch._int_mm(a, kq.t())


def _qconv(xq: torch.Tensor, kq: torch.Tensor, m: torch.Tensor,
           b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """int8 NHWC conv (1x1, or 3x3 with padding 1) as an exact int32
    product, dequantised to fp32: ``acc * m + b``."""
    bsz, h, w, cin = xq.shape
    taps = kq.shape[1] // cin
    if taps == 1:
        cols = xq[:, ::stride, ::stride] if stride > 1 else xq
    elif taps == 9:
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        cols = torch.cat([
            xp[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride]
            for dy in range(3) for dx in range(3)], dim=-1)
    else:
        raise ValueError(f"kernel [{kq.shape[0]}, {kq.shape[1]}] over "
                         f"{cin} input channels is neither 1x1 nor 3x3")
    ho, wo = cols.shape[1], cols.shape[2]
    acc = _int_mm(cols.reshape(-1, cols.shape[-1]), kq)
    return acc.float().mul_(m).add_(b).reshape(bsz, ho, wo, -1)


def _epilogue(out, identity, p, heads: int) -> torch.Tensor:
    """The bf16 MRLA epilogue: the kernel on the card, its plain version on
    the CPU (the wrapper picks by device)."""
    return mrla_light_epilogue(
        out.contiguous(), identity.contiguous(), p["wq"], p["wk"], p["wv"],
        p["lam"], p["bn_scale"], p["bn_bias"], heads)


def _qblock(yq, p, stride: int, heads: int, last: bool,
            quant_epilogue: bool):
    out1 = _qconv(yq, p["k1q"], p["m1"], p["b1"]).relu_()
    q1 = _quant(out1, p["inv_a1"])
    out2 = _qconv(q1, p["k2q"], p["m2"], p["b2"], stride=stride).relu_()
    q2 = _quant(out2, p["inv_a2"])
    z = _qconv(q2, p["k3q"], p["m3"], p["b3"])
    if "kdq" in p:
        identity = _qconv(yq, p["kdq"], p["md"], p["bd"], stride=stride)
    else:
        identity = yq.float() * p["a_in"]
    if quant_epilogue:
        y = _quant_epilogue(z, identity, p, heads)
    else:
        out = (z + identity).relu_().to(torch.bfloat16)
        y = _epilogue(out, identity.to(torch.bfloat16), p, heads).float()
    return y if last else _quant(y, p["inv_ay"])


def _qblock_bf16res(y, p, stride: int, heads: int):
    """A block with the residual stream kept bf16 (quant_residual=False):
    only the conv inputs are quantised (a fresh int8 copy a conv), so the
    identity path without downsample and the MRLA epilogue stay exact
    bf16."""
    yq = _quant(y, 1.0 / p["a_in"])
    out1 = _qconv(yq, p["k1q"], p["m1"], p["b1"]).relu_()
    q1 = _quant(out1, p["inv_a1"])
    out2 = _qconv(q1, p["k2q"], p["m2"], p["b2"], stride=stride).relu_()
    q2 = _quant(out2, p["inv_a2"])
    z = _qconv(q2, p["k3q"], p["m3"], p["b3"])
    if "kdq" in p:
        identity = _qconv(yq, p["kdq"], p["md"], p["bd"],
                          stride=stride).to(torch.bfloat16)
    else:
        identity = y.to(torch.bfloat16)
    out = (z.to(torch.bfloat16) + identity).relu_()
    return _epilogue(out, identity, p, heads).to(torch.bfloat16)


def _quant_epilogue(z, identity, p, heads: int) -> torch.Tensor:
    """The MRLA epilogue with its [B, H, W, C] stream carried int8: the GAP
    an exact integer sum (scaled after), the depthwise Wv on the int8
    stream, the residual add dequantised."""
    out_q = _quant((z + identity).relu_(), p["inv_a_out"])
    b, h, w, c = out_q.shape
    d = c // heads
    # the gate from the exact integer GAP (int64 sums)
    sums = out_q.sum(dim=(1, 2), dtype=torch.int64)
    mean = sums.float() * (p["a_out"] / (h * w))
    q = channel_conv1d(mean, p["wq"].float()).reshape(b, heads, d)
    k = channel_conv1d(mean, p["wk"].float()).reshape(b, heads, d)
    attn = torch.sigmoid((q * k).sum(-1) / math.sqrt(d))
    gate = attn.repeat_interleave(d, dim=-1)[:, None, None, :]
    # the int8 depthwise value projection in fp32: every product and
    # partial sum is an integer below 9 · 127² = 145,161 < 2²⁴, so exact
    wv = p["wvq"].float().t().reshape(c, 1, 3, 3)
    vq = F.conv2d(out_q.float().permute(0, 3, 1, 2), wv, padding=1,
                  groups=c).permute(0, 2, 3, 1)
    v = vq * p["mv"]
    mrla = v * gate + p["lam"].float() * identity
    return out_q.float() * p["a_out"] + mrla * p["bn_scale"] + p["bn_bias"]


def _qblocks(qp: Dict, yq, layers, dim_perhead, quant_epilogue,
             quant_residual=True) -> torch.Tensor:
    """Every block on a post-stem map; the final map."""
    strides, _ = _strides_for(layers)
    blocks = qp["blocks"]
    if len(blocks) != len(strides):
        raise ValueError(
            f"quant params hold {len(blocks)} blocks but layers="
            f"{tuple(layers)} implies {len(strides)}"
        )
    for i, (p, stride) in enumerate(zip(blocks, strides)):
        heads = p["lam"].shape[0] // dim_perhead
        if quant_residual:
            yq = _qblock(yq, p, stride, heads, last=i == len(blocks) - 1,
                         quant_epilogue=quant_epilogue)
        else:
            yq = _qblock_bf16res(yq, p, stride, heads)
    return yq


def _qblocks_head(qp: Dict, yq, layers, dim_perhead, quant_epilogue,
                  quant_residual=True) -> torch.Tensor:
    """Every block and the head: logits [B, classes] fp32."""
    return _head(qp, _qblocks(qp, yq, layers, dim_perhead, quant_epilogue,
                              quant_residual))


def _head(qp: Dict, y: torch.Tensor) -> torch.Tensor:
    pooled = torch.mean(y.float(), dim=(1, 2))
    fc = qp["fc"]
    return pooled @ fc["k"].float().t() + fc["b"]


@torch.inference_mode()
def resnet_mrlal_quant_forward(
    qp: Dict,
    x: torch.Tensor,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 32,
    microbatch: int = 64,
    quant_epilogue: bool = False,
    quant_residual: bool = False,
) -> torch.Tensor:
    """[B, H, W, 3] images on the params' device -> fp32 logits through the
    int8 engine.

    The stem and max pool run bf16 on the whole batch (with one
    quantisation under ``quant_residual``), then ``microbatch``-image
    chains, one after another, and the head over their maps together.
    The defaults are the accuracy-safe form (``quant_residual=False``:
    bf16 residual stream, int8 conv inputs); ``quant_residual=True`` is
    the fast lossy form (int8 residual carry, ``--quant int8-fast``);
    ``quant_epilogue=True`` also carries the epilogue's stream int8."""
    stem = qp["stem"]
    _check_device(x, stem["k"])
    y = _stem(x.to(stem["k"].dtype), stem)
    yq = _quant(y, qp["inv_a_stem"]) if quant_residual else y
    parts = chains(yq, microbatch) or [yq]
    return _head(qp, torch.cat([
        _qblocks(qp, part, layers, dim_perhead, quant_epilogue,
                 quant_residual) for part in parts]))
