"""DeiT-family inference engine (bf16 by default, weights cast once).

DeiT normalises with LayerNorm, which depends on the data, so there is
nothing to fold; what the engine does for serving:

  * the weights are cast to the serving dtype once, when the params are
    prepared; every LayerNorm's weight and bias, and the tail's packed
    vectors, stay fp32 (the statistics are taken in fp32 anyway, and the
    [C]-sized affines cost nothing);
  * dropout and DropPath are absent;
  * for a ``deit_mrlal_*`` arch every block's token tail (LN_x, LN_o, the
    gate, the depthwise 3x3 with GELU, λ, the cls bypass and the residual)
    runs in the hand-written CUDA kernel of ``kernels/deit_token_tail.py``;
    plain ``deit_*`` archs run the same engine without a tail.

Images are NHWC; tokens are [B, N, C].  On CPU tensors the kernel's plain
version runs instead, which is how the tests drive this engine.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.kernels.deit_token_tail import (
    deit_token_tail,
    pack_tail_params,
)
from mrla_tpu_torch.models.deit import LN_EPS, VisionTransformer, attention
from mrla_tpu_torch.models.registry import create_model


def prepare_deit_inference_params(
    arch_or_model: Union[str, VisionTransformer],
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    **model_kw,
) -> Dict:
    """Cast and pack; returns the serving params on ``device``.

    ``arch_or_model`` is a registered ``deit_*`` / ``deit_mrlal_*`` name
    (built with ``model_kw``) or a model instance; it gives the structure
    (patch size, heads, distillation, ``dim_mrla``).  ``state_dict`` gives
    the weights and must hold exactly the model's keys; None takes the
    instance's own."""
    dev = resolve_device(device)
    model = (create_model(arch_or_model, device="cpu", **model_kw)
             if isinstance(arch_or_model, str) else arch_or_model)
    own = model.state_dict()
    src = own if state_dict is None else {
        k.removeprefix("module."): v for k, v in state_dict.items()}
    if set(src) != set(own):
        raise ValueError(
            "state_dict does not match the model: "
            f"missing={sorted(set(own) - set(src))[:3]} "
            f"extra={sorted(set(src) - set(own))[:3]}")
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in src.items()}

    def cast(name):  # a weight in the serving dtype
        return sd[name].to(dev, dtype).contiguous()

    def affine(prefix, fp32=False):  # (weight, bias) of a Linear or LayerNorm
        to = torch.float32 if fp32 else dtype
        return (sd[f"{prefix}.weight"].to(dev, to).contiguous(),
                sd[f"{prefix}.bias"].to(dev, to).contiguous())

    tokens = [sd["cls_token"]]
    if model.distilled:
        tokens.append(sd["dist_token"])
    out: Dict = {
        "num_heads": model.num_heads,
        "dim_mrla": getattr(model, "dim_mrla", None),
        "patch": {
            "k": cast("patch_embed.proj.weight").contiguous(
                memory_format=torch.channels_last),
            "b": cast("patch_embed.proj.bias"),
        },
        "tokens": torch.cat(tokens, dim=1).to(dev, dtype),  # [1, 1 or 2, C]
        "pos": cast("pos_embed"),
        "norm": affine("norm", fp32=True),
        "head": affine("head"),
        "blocks": [],
    }
    if model.distilled:
        out["head_dist"] = affine("head_dist")
    for i in range(len(model.blocks)):
        pre = f"blocks.{i}"
        blk = {
            "norm1": affine(f"{pre}.norm1", fp32=True),
            "qkv": affine(f"{pre}.attn.qkv"),
            "proj": affine(f"{pre}.attn.proj"),
            "norm2": affine(f"{pre}.norm2", fp32=True),
            "fc1": affine(f"{pre}.mlp.fc1"),
            "fc2": affine(f"{pre}.mlp.fc2"),
        }
        if out["dim_mrla"] is not None:
            blk["tail"] = pack_tail_params(sd, f"{pre}.mrla.", dev)
        out["blocks"].append(blk)
    return out


def _layer_norm(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with fp32 statistics and the fp32 affine, rounded once to
    the dtype of x."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias,
                        LN_EPS).to(x.dtype)


def _block(x: torch.Tensor, p: Dict, num_heads: int,
           dim_mrla: Optional[int]) -> torch.Tensor:
    """One serving block; the block's input feeds the tail's recurrence."""
    ot = x
    y = F.linear(_layer_norm(x, *p["norm1"]), *p["qkv"])
    x = F.linear(attention(y, num_heads), *p["proj"]).add_(x)
    y = F.gelu(F.linear(_layer_norm(x, *p["norm2"]), *p["fc1"]))
    x = F.linear(y, *p["fc2"]).add_(x)
    if "tail" in p:
        x = deit_token_tail(x, ot, p["tail"], dim_mrla)
    return x


@torch.inference_mode()
def deit_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32.  A distilled model gives the
    mean of its two heads."""
    patch = params["patch"]
    if x.device != patch["k"].device:
        raise ValueError(f"images are on {x.device}, params on "
                         f"{patch['k'].device}")
    k = patch["k"]
    y = F.conv2d(x.to(k.dtype).permute(0, 3, 1, 2), k, patch["b"],
                 stride=k.shape[-1])
    grid = y.flatten(2).transpose(1, 2)
    prefix = params["tokens"].expand(grid.shape[0], -1, -1)
    x = torch.cat([prefix, grid], dim=1) + params["pos"]
    for p in params["blocks"]:
        x = _block(x, p, params["num_heads"], params["dim_mrla"])
    # only the cls (and dist) rows reach a head
    x = _layer_norm(x[:, :prefix.shape[1]], *params["norm"])
    logits = F.linear(x[:, 0], *params["head"])
    if "head_dist" in params:
        logits = (logits + F.linear(x[:, 1], *params["head_dist"])) / 2
    return logits.float()
