"""resnet_mrlab inference engine (BN-folded, bf16 by default): the eq. 6
K/V-cache path, PyTorch.

The same math as ``ResNetMRLABase`` in eval mode, restructured for
serving:

  * every BatchNorm is folded into the conv before it when the params are
    prepared (the deep stem's three, the bottlenecks', the shortcuts');
    ``bn_mrla`` becomes an fp32 affine on attn_t, applied before the
    optional ReLU; conv weights are cast to the serving dtype once, the MRLA
    weights and affines stay fp32;
  * each stage's cache lives in buffers allocated once for the stage's
    depth (``ops.mrla.cache_buffers``): keys [B, T, C] fp32, value maps
    [B, T, H, W, C] in the serving dtype.  Each block writes its slot in
    place; nothing copies the cache;
  * ``use_scan=False`` (the default) runs the growing-cache form: block t
    attends over the t + 1 slots written.  ``use_scan=True`` runs the
    masked fixed-length form of the JAX package's scanned stages
    (``ops.mrla.mrla_base_attention_fixed``: logits over all T slots, the
    unwritten ones masked with -inf).  The two give the same logits.

No kernel of the port runs here: the JAX engine reaches no Pallas kernel
either, and the whole path is plain PyTorch (cuDNN convolutions and
elementwise kernels).  Images and activations are NHWC; convolutions run
on NCHW views of NHWC memory.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.ops.common import conv2d_nhwc as _conv
from mrla_tpu_torch.ops.common import max_pool_same_torch
from mrla_tpu_torch.ops.mrla import (
    MRLACache,
    MRLAParams,
    cache_buffers,
    mrla_base_attention,
    mrla_base_attention_fixed,
)
from mrla_tpu_torch.serving.microbatch import chains
from mrla_tpu_torch.serving.resnet_mrlal import (
    _bn_affine,
    _check_device,
    _check_layers,
    _float_state_dict,
    _folded_conv,
)

# the deep stem's (conv, BN) pairs, as the reference keys them
DEEP_STEM_KEYS = (("conv1.0.weight", "conv1.1"),
                  ("conv1.3.weight", "conv1.4"),
                  ("conv1.6.weight", "bn1"))


def prepare_mrlab_inference_params(
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    layers: Sequence[int] = (3, 4, 6, 3),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    deep_stem: bool = True,
) -> Dict:
    """Fold BNs and cast; returns the serving params on ``device``:
    {"stem": [{"k", "b"}, ...], "stages": [[block, ...], ...], "fc"}.

    ``deep_stem=False`` takes the 7x7 stem (``resnet50_mrlab22``)."""
    dev = resolve_device(device)
    sd = _float_state_dict(model_or_state_dict)
    _check_layers(sd, layers)
    gates = [k for k in sd if ".se." in k or ".eca." in k]
    if gates:
        raise ValueError(f"the engine folds no SE / ECA gate ({gates[0]}); "
                         "run such a model as an nn.Module")
    conv = lambda kernel_key, bn_prefix: _folded_conv(
        sd, kernel_key, bn_prefix, dev, dtype)
    vec = lambda t: t.to(dev, torch.float32).contiguous()

    stem_keys = DEEP_STEM_KEYS if deep_stem else (("conv1.weight", "bn1"),)
    out: Dict = {"stem": [dict(zip("kb", conv(k, bn)))
                          for k, bn in stem_keys], "stages": []}
    for stage_idx, blocks in enumerate(layers):
        stage = []
        for block_idx in range(blocks):
            pre = f"layer{stage_idx + 1}.{block_idx}"
            blk: Dict = {}
            for ci in (1, 2, 3):
                blk[f"k{ci}"], blk[f"b{ci}"] = conv(f"{pre}.conv{ci}.weight",
                                                    f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["kd"], blk["bd"] = conv(f"{pre}.downsample.0.weight",
                                            f"{pre}.downsample.1")
            mrla = f"{pre}.mrla.mrla"
            blk["wq"] = vec(sd[f"{mrla}.Wq.weight"].reshape(-1))
            blk["wk"] = vec(sd[f"{mrla}.Wk.weight"].reshape(-1))
            blk["wv"] = vec(sd[f"{mrla}.Wv.weight"])  # [C, 1, 3, 3]
            blk["bn_scale"], blk["bn_bias"] = map(
                vec, _bn_affine(sd, f"{pre}.bn_mrla"))
            stage.append(blk)
        out["stages"].append(stage)
    out["fc"] = {"k": sd["fc.weight"].to(dev, dtype),  # [classes, C]
                 "b": vec(sd["fc.bias"])}
    return out


def _bottleneck(x, p, stride: int) -> torch.Tensor:
    out = _conv(x, p["k1"], p["b1"]).relu_()
    out = _conv(out, p["k2"], p["b2"], stride=stride).relu_()
    z = _conv(out, p["k3"], p["b3"])
    identity = _conv(x, p["kd"], p["bd"], stride=stride) if "kd" in p else x
    return z.add_(identity).relu_()


def _epilogue(out, attn_t, p, relu_on_attn: bool) -> torch.Tensor:
    """out + [ReLU](attn_t · bn_scale + bn_bias): the affine in fp32 (attn_t
    widened exactly), rounded to out's dtype before the sum."""
    attn = torch.addcmul(p["bn_bias"], attn_t, p["bn_scale"])
    if relu_on_attn:
        attn = attn.relu_()
    return out.add_(attn.to(out.dtype))


def _stage(x, blocks, stride: int, heads: int, relu_on_attn: bool,
           use_scan: bool) -> torch.Tensor:
    """One stage: its first block downsamples; the cache lives in buffers
    allocated once for the stage's depth."""
    bufs = None
    for t, p in enumerate(blocks):
        out = _bottleneck(x, p, stride if t == 0 else 1)
        params = MRLAParams(p["wq"], p["wk"], p["wv"])
        if bufs is None:
            b, h, w, c = out.shape
            bufs = cache_buffers(b, len(blocks), h, w, c, out.dtype,
                                 out.device)
            cache = MRLACache(bufs[0][:, :0], bufs[1][:, :0])
        if use_scan:
            attn_t, _, _ = mrla_base_attention_fixed(out, params, heads,
                                                     *bufs, t)
        else:
            attn_t, cache = mrla_base_attention(out, params, heads, cache)
        x = _epilogue(out, attn_t, p, relu_on_attn)
    return x


def _trunk_impl(sp: Dict, x: torch.Tensor, layers: Sequence[int],
                dim_perhead: int, relu_on_attn: bool,
                use_scan: bool) -> torch.Tensor:
    """Stem and every stage: the last stage's map."""
    stem = sp["stem"]
    _check_device(x, stem[0]["k"])
    x = x.to(stem[0]["k"].dtype)
    for i, s in enumerate(stem):
        x = _conv(x, s["k"], s["b"], stride=2 if i == 0 else 1).relu_()
    x = max_pool_same_torch(x, 3, 2)
    if [len(blocks) for blocks in sp["stages"]] != list(layers):
        raise ValueError(
            f"serving params hold stages of {[len(b) for b in sp['stages']]}"
            f" blocks but layers={tuple(layers)}")
    for stage_idx, blocks in enumerate(sp["stages"]):
        heads = blocks[0]["k3"].shape[0] // dim_perhead
        x = _stage(x, blocks, 1 if stage_idx == 0 else 2, heads,
                   relu_on_attn, use_scan)
    return x


@torch.inference_mode()
def resnet_mrlab_forward(
    sp: Dict,
    x: torch.Tensor,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 16,
    relu_on_attn: bool = True,
    use_scan: bool = False,
    microbatch: int = 0,
) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32.

    ``relu_on_attn=False`` serves ``resnet50_mrlab22``.  ``use_scan``
    chooses the masked fixed-length cache form over the growing one (same
    logits).  ``microbatch`` > 0 serves the batch as chains of that many
    images, each with caches of its own, and the head takes their maps
    together (``serving/microbatch.py``; 0, the default, serves it
    unsplit)."""
    trunk = lambda images: _trunk_impl(sp, images, layers, dim_perhead,
                                       relu_on_attn, use_scan)
    parts = chains(x, microbatch)
    y = trunk(x) if parts is None else torch.cat([trunk(p) for p in parts])
    pooled = torch.mean(y, dim=(1, 2), dtype=torch.float32)
    return pooled @ sp["fc"]["k"].float().t() + sp["fc"]["b"]
