"""resnet_mrlal inference engine (BN-folded, bf16 by default), PyTorch.

The same math as ``ResNetMRLALight`` in eval mode, restructured for
serving:

  * every BatchNorm is folded into the conv before it when the params are
    prepared: kernel' = kernel · γ/√(var+ε) over the output channel,
    bias' = β − mean·γ/√(var+ε);
  * conv weights are cast to the serving dtype once; the MRLA vectors stay
    fp32; the fc weight is kept in the serving dtype and cast to fp32 for
    the fp32 head;
  * every block's MRLA tail runs in a hand-written CUDA kernel.  A block
    whose output map is at least ``MEGATAIL_MIN_W`` wide and which has a
    next block goes through the mega-tail (``kernels/mrla_megatail.py``),
    which also computes the next block's conv1; the next block then starts
    from that activation, across a stage boundary too.  Every other block
    goes through the epilogue kernel (``kernels/mrla_epilogue.py``).

Images and activations are NHWC; convolutions run on NCHW views of NHWC
memory (channels_last), so no layout copies are made.  On CPU tensors the
kernels' plain versions run instead, which is how the tests drive this
engine.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.kernels.mrla_epilogue import (
    mrla_light_epilogue,
    mrla_light_gate,
)
from mrla_tpu_torch.kernels.mrla_megatail import mrla_block_tail_fused_next
from mrla_tpu_torch.ops.common import max_pool_same_torch

BN_EPS = 1e-5
MEGATAIL_MIN_W = 28


def _bn_affine(sd: Mapping, prefix: str):
    s = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + BN_EPS)
    return s, sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * s


def prepare_inference_params(
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    layers: Sequence[int] = (3, 4, 6, 3),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Dict:
    """Fold BNs and cast; returns the serving params on ``device``."""
    dev = resolve_device(device)
    src = (model_or_state_dict.state_dict()
           if isinstance(model_or_state_dict, nn.Module)
           else model_or_state_dict)
    sd = {k.removeprefix("module."): v.detach().to("cpu", torch.float32)
          for k, v in src.items() if not k.endswith("num_batches_tracked")}

    def conv(kernel_key: str, bn_prefix: str):
        s, b = _bn_affine(sd, bn_prefix)
        k = sd[kernel_key] * s[:, None, None, None]
        return (k.to(dev, dtype).contiguous(memory_format=torch.channels_last),
                b.to(dev, dtype))

    def vec(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev, torch.float32).contiguous()

    # Every layer{s}.{b} block must be consumed: a subset would serve a
    # truncated network with valid shapes.
    expect = {f"layer{s + 1}.{b}" for s, n in enumerate(layers)
              for b in range(n)}
    have = {".".join(k.split(".")[:2]) for k in sd if k.startswith("layer")}
    if have != expect:
        raise ValueError(
            f"layers={tuple(layers)} does not match the state_dict: "
            f"missing={sorted(expect - have)[:3]} "
            f"extra={sorted(have - expect)[:3]}"
        )

    out: Dict = {}
    k, b = conv("conv1.weight", "bn1")
    out["stem"] = {"k": k, "b": b}
    out["blocks"] = []
    for stage_idx, blocks in enumerate(layers):
        for block_idx in range(blocks):
            pre = f"layer{stage_idx + 1}.{block_idx}"
            blk: Dict = {}
            for ci in (1, 2, 3):
                blk[f"k{ci}"], blk[f"b{ci}"] = conv(f"{pre}.conv{ci}.weight",
                                                    f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["kd"], blk["bd"] = conv(f"{pre}.downsample.0.weight",
                                            f"{pre}.downsample.1")
            # bn_mrla folds into (scale, bias) applied after (attn + λ·id)
            s, bb = _bn_affine(sd, f"{pre}.bn_mrla")
            wv = sd[f"{pre}.mrla.mrla.Wv.weight"]  # [C, 1, 3, 3]
            blk["wq"] = vec(sd[f"{pre}.mrla.mrla.Wq.weight"].reshape(-1))
            blk["wk"] = vec(sd[f"{pre}.mrla.mrla.Wk.weight"].reshape(-1))
            blk["wv"] = vec(wv.reshape(wv.shape[0], 9).t())  # [9, C]
            blk["lam"] = vec(sd[f"{pre}.mrla.lambda_t"].reshape(-1))
            blk["bn_scale"] = vec(s)
            blk["bn_bias"] = vec(bb)
            out["blocks"].append(blk)

    out["fc"] = {"k": sd["fc.weight"].to(dev, dtype),  # [classes, C]
                 "b": vec(sd["fc.bias"])}
    return out


def _conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
          stride: int = 1) -> torch.Tensor:
    """NHWC conv with torch-style symmetric padding (k // 2 on each side)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k, b, stride=stride,
                 padding=k.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _block(x, p, stride: int, heads: int, x1_pre=None, p_next=None):
    """One serving block.  ``x1_pre``, if given, is relu(conv1(x)) computed
    by the previous block's mega-tail.  Returns (y, x1_next), where x1_next
    is the next block's post-conv1 activation when the mega-tail ran, else
    None."""
    out = x1_pre if x1_pre is not None else _conv(x, p["k1"], p["b1"]).relu_()
    out = _conv(out, p["k2"], p["b2"], stride=stride).relu_()
    z = _conv(out, p["k3"], p["b3"])
    identity = _conv(x, p["kd"], p["bd"], stride=stride) if "kd" in p else x
    # relu(z + id), in place on the fresh conv output.  One rounding of the
    # sum to the activation dtype, as relu(z.float() + id.float()).to(dtype).
    out = z.add_(identity).relu_()
    if out.shape[2] >= MEGATAIL_MIN_W and p_next is not None:
        gate = mrla_light_gate(out, p["wq"], p["wk"], heads)
        return mrla_block_tail_fused_next(
            out, identity, gate, p["wv"], p["lam"], p["bn_scale"],
            p["bn_bias"], p_next["k1"], p_next["b1"],
        )
    return mrla_light_epilogue(
        out, identity, p["wq"], p["wk"], p["wv"], p["lam"], p["bn_scale"],
        p["bn_bias"], heads,
    ), None


@torch.inference_mode()
def resnet_mrlal_forward(
    serving_params: Dict,
    x: torch.Tensor,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 32,
) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32."""
    stem = serving_params["stem"]
    if x.device != stem["k"].device:
        raise ValueError(f"images are on {x.device}, params on "
                         f"{stem['k'].device}")
    strides = [2 if (s > 0 and b == 0) else 1
               for s, n in enumerate(layers) for b in range(n)]
    blocks = serving_params["blocks"]
    if len(blocks) != len(strides):
        raise ValueError(
            f"serving params hold {len(blocks)} blocks but layers="
            f"{tuple(layers)} implies {len(strides)}"
        )
    y = _conv(x.to(stem["k"].dtype), stem["k"], stem["b"], stride=2).relu_()
    y = max_pool_same_torch(y, 3, 2)
    x1_pre = None
    for i, (p, stride) in enumerate(zip(blocks, strides)):
        heads = p["lam"].shape[0] // dim_perhead
        p_next = blocks[i + 1] if i + 1 < len(blocks) else None
        # the conv1 hand-off stays valid across stage boundaries: conv1 is
        # stride 1 and consumes exactly this block's output y
        y, x1_pre = _block(y, p, stride, heads, x1_pre=x1_pre, p_next=p_next)
    pooled = torch.mean(y, dim=(1, 2), dtype=torch.float32)
    fc = serving_params["fc"]
    return pooled @ fc["k"].float().t() + fc["b"]
