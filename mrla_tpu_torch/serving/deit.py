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
    plain ``deit_*`` archs run the same engine without a tail;
  * for a ``deit_mrlab_*`` arch every block ends in the MRLA-base token
    module in plain PyTorch, as the JAX package computes it (no Pallas
    kernel there either): LayerNorm ``normx`` with fp32 statistics, the
    base attention on the token grid against the cache of the blocks before
    it (``ops.mrla.mrla_base_attention``, buffers allocated once a cache
    period), the normalised cls row passed through; the cache restarts
    every ``mrlab_size`` blocks and ``dim_mrla`` sets the heads.

Images are NHWC; tokens are [B, N, C].  On CPU tensors the kernel's plain
version runs instead, which is how the tests drive this engine.
"""

from __future__ import annotations

import math
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
from mrla_tpu_torch.ops.mrla import MRLACache, MRLAParams, mrla_base_attention
from mrla_tpu_torch.serving.microbatch import chains


def prepare_deit_inference_params(
    arch_or_model: Union[str, VisionTransformer],
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    **model_kw,
) -> Dict:
    """Cast and pack; returns the serving params on ``device``.

    ``arch_or_model`` is a registered ``deit_*`` / ``deit_mrlal_*`` /
    ``deit_mrlab_*`` name (built with ``model_kw``) or a model instance; it
    gives the structure (patch size, heads, distillation, ``dim_mrla``, the
    MRLA variant and ``mrlab_size``).  ``state_dict`` gives
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
        "variant": getattr(model, "variant", None),
        "mrlab_size": getattr(model, "mrlab_size", None),
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
        if out["variant"] == "light":
            blk["tail"] = pack_tail_params(sd, f"{pre}.mrla.", dev)
        elif out["variant"] == "base":
            blk["mrlab"] = {
                "normx": affine(f"{pre}.mrla.normx", fp32=True),
                "params": MRLAParams(*(
                    sd[f"{pre}.mrla.mrla.W{w}.weight"].to(dev)
                    for w in "qkv")),
            }
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


def _mrlab_tail(x: torch.Tensor, p: Dict, dim_mrla: int,
                cache: Optional[MRLACache], max_t: int):
    """x + the MRLA-base token module on x -> (x, the cache with this
    block appended)."""
    b, n, c = x.shape
    normx = _layer_norm(x, *p["normx"])
    grid = normx[:, 1:].reshape(b, math.isqrt(n - 1), -1, c)
    attn, cache = mrla_base_attention(grid, p["params"], c // dim_mrla,
                                      cache, max_t)
    tail = torch.cat([normx[:, :1], attn.reshape(b, n - 1, c)], dim=1)
    return x.add_(tail), cache


def _tokens_impl(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Patch embedding and every block: the cls (and dist) rows."""
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
    blocks, period = params["blocks"], params["mrlab_size"]
    for i, p in enumerate(blocks):
        x = _block(x, p, params["num_heads"], params["dim_mrla"])
        if "mrlab" in p:
            if i % period == 0:  # init_cell
                cache = None
            x, cache = _mrlab_tail(x, p["mrlab"], params["dim_mrla"], cache,
                                   min(period, len(blocks) - i))
    return x[:, :prefix.shape[1]]  # only these rows reach a head


@torch.inference_mode()
def deit_forward(params: Dict, x: torch.Tensor,
                 microbatch: int = 0) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32.  A distilled model gives the
    mean of its two heads.  ``microbatch`` > 0 serves the batch as chains
    of that many images, one after another, and the head takes their rows
    together (``serving/microbatch.py``; 0, the default, serves it
    unsplit)."""
    parts = chains(x, microbatch)
    x = (_tokens_impl(params, x) if parts is None
         else torch.cat([_tokens_impl(params, p) for p in parts]))
    x = _layer_norm(x, *params["norm"])
    logits = F.linear(x[:, 0], *params["head"])
    if "head_dist" in params:
        logits = (logits + F.linear(x[:, 1], *params["head_dist"])) / 2
    return logits.float()
