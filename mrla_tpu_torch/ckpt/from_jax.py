"""JAX/Flax variables -> the port's ``state_dict`` (every family of the
registry: ``arch_state_dict_from_jax`` picks the converter by arch), and a
JAX serving tree -> the port's serving params (resnet mrlal and mrlab).

The exact inverse of the JAX package's ``convert_resnet_state_dict`` for
the resnet families (baseline, SE, ECA, ResNeXt, the dw ablation, mrlal,
mrlab, LA eq. 4), from plain numpy:

    params/stem/conv1/kernel            -> conv1.weight               (HWIO->OIHW)
    params/stem/conv1{a,b,c}/kernel     -> conv1.{0,3,6}.weight       (deep stem)
    .../stem/bn1{a,b}/*                 -> conv1.{1,4}.*              (deep stem)
    {params,batch_stats}/stem/bn1/*     -> bn1.*
    params/layer{s}_{b}/conv{i}/kernel  -> layer{s}.{b}.conv{i}.weight
    .../bn{i}, .../bn_mrla              -> layer{s}.{b}.bn{i}.*, .bn_mrla.*
    .../downsample/conv/kernel          -> layer{s}.{b}.downsample.0.weight
    .../downsample/bn/*                 -> layer{s}.{b}.downsample.1.*
    .../mrla/mrla/proj/w{q,k} [k]       -> layer{s}.{b}.mrla.mrla.W{q,k}.weight [1,1,k]
    .../mrla/mrla/proj/wv [3,3,1,C]     -> layer{s}.{b}.mrla.mrla.Wv.weight [C,1,3,3]
    .../mrla/lambda_t [C]               -> layer{s}.{b}.mrla.lambda_t [C,1,1]
                                           (light only: base has no λ)
    .../la_proj/w{q,k,v}                -> layer{s}.{b}.la.W{q,k,v}.weight
    .../bn_la                           -> layer{s}.{b}.bn_la.*
    .../se/w{1,2} [in, out]             -> layer{s}.{b}.se.fc.{0,2}.weight [out, in]
    .../eca/w [k]                       -> layer{s}.{b}.eca.conv.weight [1,1,k]
    .../dwconv/kernel [3,3,1,C], .../bn_dw -> layer{s}.{b}.dwconv.weight, .bn_dw.*
    params/head/fc/{kernel,bias}        -> fc.{weight,bias}           (kernel transposed)

(a grouped conv2 kernel [3,3,I/g,O] becomes [O,I/g,3,3] as any other).

BN leaves map scale/bias/mean/var -> weight/bias/running_mean/running_var,
and every BN gets ``num_batches_tracked`` = 0 so the result loads with
``load_state_dict(strict=True)``.

``serving_params_from_jax`` converts the BN-folded tree that the JAX
package's ``prepare_inference_params`` returns (or raw block dicts of the
same layout) into what the port's ``prepare_inference_params`` returns:

    stem/k [7,7,3,O] HWIO, stem/k_s2d [4,4,12,O] -> [O,3,7,7], [O,12,4,4]
    blocks[i]/k1..k3, kd  HWIO                   -> [out, in, kh, kw]
    blocks[i]/wv [3,3,1,C]                       -> [9, C]
    blocks[i]/wq, wk, lam, bn_scale, bn_bias     -> flat fp32 vectors
    fc/k [C, classes]                            -> [classes, C]

``mrlab_serving_params_from_jax`` converts the tree that the JAX
package's ``prepare_mrlab_inference_params`` returns (the stem list, each
stage's ``first`` block and its stacked ``interior`` blocks) into what the
port's ``prepare_mrlab_inference_params`` returns: the same layouts as
above, ``wv`` [3,3,1,C] -> [C,1,3,3], blocks listed per stage.

``vit_state_dict_from_jax`` is the exact inverse of the JAX package's
``convert_vit_state_dict`` for the plain (distilled or not), light and base
variants:

    params/{cls_token,dist_token,pos_embed}      -> the same names
    params/patch_embed/proj/kernel [p,p,3,C]     -> patch_embed.proj.weight (HWIO->OIHW)
    params/block{i}/norm{1,2}/{scale,bias}       -> blocks.{i}.norm{1,2}.{weight,bias}
    .../attn/{qkv,proj}, .../mlp/{fc1,fc2}       -> blocks.{i}.attn.*, .mlp.* (kernel transposed)
    .../mrla/norm{x,o}/{scale,bias}              -> blocks.{i}.mrla.norm{x,o}.{weight,bias}
    .../mrla/lambda_t [C]                        -> blocks.{i}.mrla.lambda_t [C]
    .../mrla/mrla/proj/w{q,k} [k]                -> blocks.{i}.mrla.mrla.W{q,k}.weight [1,1,k]
    .../mrla/mrla/proj/wv [3,3,1,C]              -> blocks.{i}.mrla.mrla.Wv.weight [C,1,3,3]
    .../mrla/mrla/mrla/proj/w{q,k,v} (base)      -> blocks.{i}.mrla.mrla.W{q,k,v}.weight
    params/norm, params/head, params/head_dist   -> norm.*, head.*, head_dist.*

``efficientnet_state_dict_from_jax``, ``resmlp_state_dict_from_jax`` and
``patchconvnet_state_dict_from_jax`` turn the Flax trees of those models
into the port's keys (``models/efficientnet_mrla.py`` keys the Flax paths
dotted; ResMLP and PatchConvNet the reference's, as
``tests/test_resmlp_patchconvnet.py`` maps them): convs HWIO -> OIHW,
Dense kernels transposed, LayerNorm scale -> weight, a PatchConvNet SE
Dense [C, C/4] -> a 1x1 conv [C/4, C, 1, 1], the multi-class head's
stacked ``head_multi_kernel`` [K, C] / ``head_multi_bias`` [K] -> K
``head.{i}`` Linears [1, C] / [1].

``tail_params_from_jax`` pulls one block's tail out of its Flax subtree in
the form ``pack_tail_params`` takes.

``detector_state_dict_from_jax`` is the exact inverse of the JAX package's
``convert_mmdet_two_stage``: a Flax ``FasterRCNN`` / ``MaskRCNN`` tree ->
the mmdet-keyed ``state_dict`` the port's detectors load:

    params/backbone, batch_stats/backbone    -> backbone.*  (as above, no fc)
    params/neck/lateral{i}, fpn_conv{i}      -> neck.lateral_convs.{i}.conv.*,
                                                neck.fpn_convs.{i}.conv.*
    params/neck/extra_conv{i}                -> neck.fpn_convs.{i}.conv.*
    params/rpn_head/rpn_{conv,cls,reg}       -> rpn_head.rpn_{conv,cls,reg}.*
    params/bbox_head/shared_fc0 [49*C, O]    -> roi_head.bbox_head.shared_fcs.0
                                                [O, C*49] ([7,7,C] rows
                                                re-indexed to mmdet's [C,7,7])
    params/bbox_head/shared_fc1, fc_cls, fc_reg -> shared_fcs.1, fc_cls, fc_reg
    params/mask_head/conv{i}                 -> roi_head.mask_head.convs.{i}
                                                .conv.*
    params/mask_head/upsample [kh,kw,I,O]    -> roi_head.mask_head.upsample
                                                [I,O,kh,kw], taps rot180
    params/mask_head/conv_logits             -> roi_head.mask_head.conv_logits
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch

from mrla_tpu_torch._device import resolve_device

_BN_LEAVES = (
    ("params", "scale", "weight"),
    ("params", "bias", "bias"),
    ("batch_stats", "mean", "running_mean"),
    ("batch_stats", "var", "running_var"),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a C-ordered, writable copy


def _oihw(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn_leaves(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A BN's params ``p`` and statistics ``s`` -> ``{prefix}.*``."""
    for col, leaf, name in _BN_LEAVES:
        sd[f"{prefix}.{name}"] = _t((p if col == "params" else s)[leaf])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


# the deep stem's (conv, the BN inside conv1) pairs; bn1 follows conv1c
_DEEP_STEM = (("conv1a", "bn1a"), ("conv1b", "bn1b"), ("conv1c", None))


def _projections(sd: Dict, prefix: str, proj: Mapping) -> None:
    """An MRLA projection subtree (wq, wk [k]; wv [3,3,1,C]) ->
    ``{prefix}.W{q,k,v}.weight``."""
    sd[f"{prefix}.Wq.weight"] = _t(proj["wq"]).reshape(1, 1, -1)
    sd[f"{prefix}.Wk.weight"] = _t(proj["wk"]).reshape(1, 1, -1)
    sd[f"{prefix}.Wv.weight"] = _oihw(proj["wv"])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` (numpy or array leaves) -> state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    bn = lambda prefix, p, s: _bn_leaves(sd, prefix, p, s)
    stem, stem_stats = params["stem"], stats["stem"]
    if "conv1a" in stem:  # the deep stem
        for i, (conv, norm) in enumerate(_DEEP_STEM):
            sd[f"conv1.{3 * i}.weight"] = _oihw(stem[conv]["kernel"])
            if norm:
                bn(f"conv1.{3 * i + 1}", stem[norm], stem_stats[norm])
    else:
        sd["conv1.weight"] = _oihw(stem["conv1"]["kernel"])
    bn("bn1", stem["bn1"], stem_stats["bn1"])

    blocks = sorted(
        (n for n in params if n.startswith("layer")),
        key=lambda n: tuple(int(v) for v in n[5:].split("_")),
    )
    for name in blocks:
        stage, block = name[5:].split("_")
        pre = f"layer{stage}.{block}"
        p, s = params[name], stats[name]
        for ci in (1, 2, 3):
            sd[f"{pre}.conv{ci}.weight"] = _oihw(p[f"conv{ci}"]["kernel"])
            bn(f"{pre}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
        if "downsample" in p:
            sd[f"{pre}.downsample.0.weight"] = _oihw(
                p["downsample"]["conv"]["kernel"]
            )
            bn(f"{pre}.downsample.1", p["downsample"]["bn"],
               s["downsample"]["bn"])
        if "se" in p:  # [in, out] -> Linear [out, in]
            sd[f"{pre}.se.fc.0.weight"] = _t(np.asarray(p["se"]["w1"]).T)
            sd[f"{pre}.se.fc.2.weight"] = _t(np.asarray(p["se"]["w2"]).T)
        if "eca" in p:
            sd[f"{pre}.eca.conv.weight"] = _t(p["eca"]["w"]).reshape(1, 1, -1)
        if "dwconv" in p:  # the dw ablation
            sd[f"{pre}.dwconv.weight"] = _oihw(p["dwconv"]["kernel"])
            bn(f"{pre}.bn_dw", p["bn_dw"], s["bn_dw"])
        if "la_proj" in p:  # LA eq. 4
            _projections(sd, f"{pre}.la", p["la_proj"])
            bn(f"{pre}.bn_la", p["bn_la"], s["bn_la"])
        if "mrla" in p:
            _projections(sd, f"{pre}.mrla.mrla", p["mrla"]["mrla"]["proj"])
            if "lambda_t" in p["mrla"]:  # light; base has no λ
                sd[f"{pre}.mrla.lambda_t"] = _t(
                    p["mrla"]["lambda_t"]).reshape(-1, 1, 1)
            bn(f"{pre}.bn_mrla", p["bn_mrla"], s["bn_mrla"])

    if "head" in params:  # a features_only backbone has none
        sd["fc.weight"] = _t(np.asarray(params["head"]["fc"]["kernel"]).T)
        sd["fc.bias"] = _t(params["head"]["fc"]["bias"])
    return sd


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _oihw(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def detector_state_dict_from_jax(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a Flax ``FasterRCNN`` /
    ``MaskRCNN`` / ``MRLABackboneFPN`` (numpy or array leaves) -> the
    mmdet-keyed state_dict (the inverse of ``convert_mmdet_two_stage``)."""
    params = variables["params"]
    sd = {f"backbone.{k}": v for k, v in state_dict_from_jax(
        {"params": params["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}).items()}
    for name, p in params["neck"].items():
        if name.startswith("lateral"):
            _conv(sd, f"neck.lateral_convs.{int(name[7:])}.conv", p)
        elif name.startswith("fpn_conv"):
            _conv(sd, f"neck.fpn_convs.{int(name[8:])}.conv", p)
        elif name.startswith("extra_conv"):
            _conv(sd, f"neck.fpn_convs.{int(name[10:])}.conv", p)
        else:
            raise ValueError(f"unrecognized neck module: {name}")
    for name, p in params.get("rpn_head", {}).items():
        _conv(sd, f"rpn_head.{name}", p)
    if "bbox_head" in params:
        pre = "roi_head.bbox_head"
        for name, p in params["bbox_head"].items():
            key = (f"{pre}.shared_fcs.{int(name[9:])}"
                   if name.startswith("shared_fc") else f"{pre}.{name}")
            k = np.asarray(p["kernel"])
            if name == "shared_fc0":  # rows [7, 7, C] -> columns [C, 7, 7]
                k = k.reshape(7, 7, -1, k.shape[-1]).transpose(3, 2, 0, 1)
                sd[f"{key}.weight"] = _t(k.reshape(k.shape[0], -1))
            else:
                sd[f"{key}.weight"] = _t(k.T)
            sd[f"{key}.bias"] = _t(p["bias"])
    if "mask_head" in params:
        pre = "roi_head.mask_head"
        for name, p in params["mask_head"].items():
            if name.startswith("conv") and name[4:].isdigit():
                _conv(sd, f"{pre}.convs.{int(name[4:])}.conv", p)
            elif name == "upsample":  # flax correlates: taps rot180
                k = np.asarray(p["kernel"])[::-1, ::-1]
                sd[f"{pre}.upsample.weight"] = _t(k.transpose(2, 3, 0, 1))
                sd[f"{pre}.upsample.bias"] = _t(p["bias"])
            elif name == "conv_logits":
                _conv(sd, f"{pre}.conv_logits", p)
            else:
                raise ValueError(f"unrecognized mask_head module: {name}")
    return sd


def serving_params_from_jax(tree: Mapping, device="cuda",
                            dtype: torch.dtype = torch.bfloat16) -> Dict:
    """A JAX serving tree (numpy or array leaves) -> the port's serving
    params on ``device``: conv weights and biases and the fc weight in
    ``dtype``, the MRLA vectors and the fc bias fp32.  ``stem``, ``fc`` and
    ``k_s2d`` are optional."""
    dev = resolve_device(device)

    def conv(k):  # through fp32: numpy has no native bfloat16
        return _oihw(np.asarray(k, np.float32)).to(dev, dtype).contiguous(
            memory_format=torch.channels_last)

    def vec(a):
        return _t(np.asarray(a, np.float32)).reshape(-1).to(dev)

    out: Dict = {"blocks": []}
    if "stem" in tree:
        stem = tree["stem"]
        out["stem"] = {"k": conv(stem["k"]),
                       "b": vec(stem["b"]).to(dtype)}
        if "k_s2d" in stem:
            out["stem"]["k_s2d"] = conv(stem["k_s2d"])
    for p in tree["blocks"]:
        blk: Dict = {}
        for name in ("1", "2", "3", "d"):
            if f"k{name}" in p:
                blk[f"k{name}"] = conv(p[f"k{name}"])
                blk[f"b{name}"] = vec(p[f"b{name}"]).to(dtype)
        for name in ("wq", "wk", "lam", "bn_scale", "bn_bias"):
            blk[name] = vec(p[name])
        wv = np.asarray(p["wv"], np.float32)  # [3, 3, 1, C]
        blk["wv"] = _t(wv.reshape(9, wv.shape[-1])).to(dev)
        out["blocks"].append(blk)
    if "fc" in tree:
        out["fc"] = {
            "k": _t(np.asarray(tree["fc"]["k"], np.float32).T).to(dev, dtype),
            "b": vec(tree["fc"]["b"]),
        }
    return out


def mrlab_serving_params_from_jax(tree: Mapping, device="cuda",
                                  dtype: torch.dtype = torch.bfloat16) -> Dict:
    """A JAX MRLA-base serving tree (numpy or array leaves) -> the port's
    mrlab serving params on ``device``: conv weights and biases and the fc
    weight in ``dtype``; the MRLA vectors, ``wv`` and the fc bias fp32."""
    dev = resolve_device(device)

    def conv(k):  # through fp32: numpy has no native bfloat16
        return _oihw(np.asarray(k, np.float32)).to(dev, dtype).contiguous(
            memory_format=torch.channels_last)

    def vec(a):
        return _t(np.asarray(a, np.float32)).reshape(-1).to(dev)

    def block(p) -> Dict:
        blk: Dict = {}
        for name in ("1", "2", "3", "d"):
            if f"k{name}" in p:
                blk[f"k{name}"] = conv(p[f"k{name}"])
                blk[f"b{name}"] = vec(p[f"b{name}"]).to(dtype)
        for name in ("wq", "wk", "bn_scale", "bn_bias"):
            blk[name] = vec(p[name])
        blk["wv"] = _oihw(np.asarray(p["wv"], np.float32)).to(dev)
        return blk

    out: Dict = {
        "stem": [{"k": conv(s["k"]), "b": vec(s["b"]).to(dtype)}
                 for s in tree["stem"]],
        "stages": [],
        "fc": {"k": _t(np.asarray(tree["fc"]["k"], np.float32).T).to(
                   dev, dtype),
               "b": vec(tree["fc"]["b"])},
    }
    for stage in tree["stages"]:
        blocks = [block(stage["first"])]
        interior = stage["interior"]
        if interior is not None:
            n = np.asarray(interior["wq"]).shape[0]
            blocks += [block({k: np.asarray(v)[i]
                              for k, v in interior.items()})
                       for i in range(n)]
        out["stages"].append(blocks)
    return out


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def tail_params_from_jax(block_params: Mapping) -> Dict[str, torch.Tensor]:
    """The tail's weights of one Flax ``MRLAViTBlock`` subtree
    (``variables["params"]["block{i}"]``) under the port's ``state_dict``
    names relative to the token module (``normx.weight`` ..
    ``mrla.Wv.weight``): what ``pack_tail_params`` takes."""
    m = block_params["mrla"]
    proj = m["mrla"]["proj"]
    sd: Dict[str, torch.Tensor] = {}
    _ln(sd, "normx", m["normx"])
    _ln(sd, "normo", m["normo"])
    sd["lambda_t"] = _t(m["lambda_t"]).reshape(-1)
    _projections(sd, "mrla", proj)
    return sd


def vit_state_dict_from_jax(variables: Mapping,
                            variant: str = "light") -> Dict[str, torch.Tensor]:
    """``{"params"}`` of a Flax DeiT (numpy or array leaves) -> state_dict.
    ``variant`` is ``"plain"`` (``VisionTransformer``, distilled or not),
    ``"light"`` or ``"base"`` (``ViTMRLA``)."""
    if variant not in ("plain", "light", "base"):
        raise ValueError("variant must be 'plain', 'light' or 'base', got "
                         f"{variant!r}")
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name in ("cls_token", "dist_token", "pos_embed"):
        if name in params:
            sd[name] = _t(params[name])
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = _oihw(proj["kernel"])
    sd["patch_embed.proj.bias"] = _t(proj["bias"])
    blocks = sorted((n for n in params if n.startswith("block")),
                    key=lambda n: int(n[5:]))
    for name in blocks:
        p, pre = params[name], f"blocks.{int(name[5:])}"
        _ln(sd, f"{pre}.norm1", p["norm1"])
        _ln(sd, f"{pre}.norm2", p["norm2"])
        _dense(sd, f"{pre}.attn.qkv", p["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", p["attn"]["proj"])
        _dense(sd, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", p["mlp"]["fc2"])
        kind = ("plain" if "mrla" not in p
                else "light" if "normo" in p["mrla"] else "base")
        if kind != variant:
            raise ValueError(f"{name} does not fit variant={variant!r}")
        if variant == "light":
            for k, v in tail_params_from_jax(p).items():
                sd[f"{pre}.mrla.{k}"] = v
        elif variant == "base":
            _ln(sd, f"{pre}.mrla.normx", p["mrla"]["normx"])
            _projections(sd, f"{pre}.mrla.mrla",
                         p["mrla"]["mrla"]["mrla"]["proj"])
    _ln(sd, "norm", params["norm"])
    _dense(sd, "head", params["head"])
    if "head_dist" in params:
        _dense(sd, "head_dist", params["head_dist"])
    return sd


def efficientnet_state_dict_from_jax(variables: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a Flax ``EfficientNet`` -> the
    port's state_dict (``models/efficientnet_mrla.py``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name == "classifier":
            _dense(sd, name, p)
        elif name.endswith("_conv"):  # stem_conv, head_conv
            sd[f"{name}.weight"] = _oihw(p["kernel"])
        elif name.endswith("_bn"):
            _bn_leaves(sd, name, p, stats[name])
        elif name.startswith("stage"):
            for sub, q in p.items():
                pre = f"{name}.{sub}"
                if sub.endswith("_conv"):
                    sd[f"{pre}.weight"] = _oihw(q["kernel"])
                elif sub.startswith("bn"):
                    _bn_leaves(sd, pre, q, stats[name][sub])
                elif sub == "se":
                    _dense(sd, f"{pre}.fc1", q["fc1"])
                    _dense(sd, f"{pre}.fc2", q["fc2"])
                elif sub == "mrla":
                    _projections(sd, f"{pre}.mrla", q["mrla"]["proj"])
                    sd[f"{pre}.lambda_t"] = _t(q["lambda_t"]).reshape(
                        -1, 1, 1)
                else:
                    raise ValueError(f"unrecognized module {name}/{sub}")
        else:
            raise ValueError(f"unrecognized module {name}")
    return sd


def _affine(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.alpha"] = _t(p["alpha"])
    sd[f"{prefix}.beta"] = _t(p["beta"])


def resmlp_state_dict_from_jax(variables: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """``{"params"}`` of a Flax ``ResMLP`` -> the port's (the reference's)
    state_dict."""
    params = variables["params"]
    proj = params["patch_embed"]["proj"]
    sd: Dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": _oihw(proj["kernel"]),
        "patch_embed.proj.bias": _t(proj["bias"])}
    for name in sorted((n for n in params if n.startswith("block")),
                       key=lambda n: int(n[5:])):
        p, pre = params[name], f"blocks.{int(name[5:])}"
        _affine(sd, f"{pre}.norm1", p["norm1"])
        _affine(sd, f"{pre}.norm2", p["norm2"])
        _dense(sd, f"{pre}.attn", p["attn"])
        _dense(sd, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", p["mlp"]["fc2"])
        sd[f"{pre}.gamma_1"] = _t(p["gamma_1"])
        sd[f"{pre}.gamma_2"] = _t(p["gamma_2"])
    _affine(sd, "norm", params["norm"])
    _dense(sd, "head", params["head"])
    return sd


def patchconvnet_state_dict_from_jax(variables: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """``{"params"}`` of a Flax ``PatchConvNet`` (single- or multi-class)
    -> the port's (the reference's) state_dict."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(4):
        sd[f"patch_embed.proj.{2 * i}.0.weight"] = _oihw(
            params["patch_embed"][f"conv{i}"]["kernel"])
    depth = sum(1 for n in params if n.startswith("block"))
    for i in range(depth):
        p, pre = params[f"block{i}"], f"blocks.{i}"
        _ln(sd, f"{pre}.norm1", params[f"norm{i}"])
        sd[f"{pre}.gamma_1"] = _t(params[f"gamma_{i}"])
        conv = f"{pre}.attn.qkv_pos"
        for idx, sub in ((0, "pw1"), (2, "dw"), (5, "pw2")):
            _conv(sd, f"{conv}.{idx}", p[sub])
        for sub, se in (("se_fc1", "conv_reduce"), ("se_fc2", "conv_expand")):
            k = np.asarray(p[sub]["kernel"]).T  # [out, in]
            sd[f"{conv}.4.{se}.weight"] = _t(k[:, :, None, None])
            sd[f"{conv}.4.{se}.bias"] = _t(p[sub]["bias"])
    sd["cls_token"] = _t(params["cls_token"])
    pre = "blocks_token_only.0"
    sd[f"{pre}.gamma_1"] = _t(params["cls_gamma_1"])
    sd[f"{pre}.gamma_2"] = _t(params["cls_gamma_2"])
    _ln(sd, f"{pre}.norm1", params["cls_norm1"])
    _ln(sd, f"{pre}.norm2", params["cls_norm2"])
    for sub in ("q", "k", "v", "proj"):
        _dense(sd, f"{pre}.attn.{sub}", params["cls_attn"][sub])
    _dense(sd, f"{pre}.mlp.fc1", params["cls_mlp"]["fc1"])
    _dense(sd, f"{pre}.mlp.fc2", params["cls_mlp"]["fc2"])
    _ln(sd, "norm", params["norm"])
    if "head_multi_kernel" in params:  # a Linear(C, 1) a class
        k = np.asarray(params["head_multi_kernel"])
        b = np.asarray(params["head_multi_bias"])
        for i in range(k.shape[0]):
            sd[f"head.{i}.weight"] = _t(k[i:i + 1])
            sd[f"head.{i}.bias"] = _t(b[i:i + 1])
    else:
        _dense(sd, "head", params["head"])
    return sd


def converter_for(arch: str):
    """The function that takes ``arch``'s Flax variables to the port's
    state_dict (``vit_state_dict_from_jax`` with the arch's variant bound)."""
    if arch.startswith("deit"):
        variant = ("light" if "_mrlal" in arch else
                   "base" if "_mrlab" in arch else "plain")
        return functools.partial(vit_state_dict_from_jax, variant=variant)
    for prefix, fn in (("efficientnet", efficientnet_state_dict_from_jax),
                       ("resmlp", resmlp_state_dict_from_jax),
                       ("patchconvnet", patchconvnet_state_dict_from_jax),
                       ("resnet", state_dict_from_jax),
                       ("resnext", state_dict_from_jax)):
        if arch.startswith(prefix):
            return fn
    raise ValueError(f"no converter for arch {arch!r}")


def arch_state_dict_from_jax(arch: str, variables: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """``arch``'s Flax variables (numpy or array leaves) -> the port's
    state_dict, by the arch's family."""
    return converter_for(arch)(variables)
