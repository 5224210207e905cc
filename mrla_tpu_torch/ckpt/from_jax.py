"""JAX/Flax variables -> the port's ``state_dict``, and a JAX serving tree
-> the port's serving params (resnet mrlal family).

The exact inverse of the JAX package's ``convert_resnet_state_dict`` for
the mrlal family, from plain numpy:

    params/stem/conv1/kernel            -> conv1.weight               (HWIO->OIHW)
    {params,batch_stats}/stem/bn1/*     -> bn1.*
    params/layer{s}_{b}/conv{i}/kernel  -> layer{s}.{b}.conv{i}.weight
    .../bn{i}, .../bn_mrla              -> layer{s}.{b}.bn{i}.*, .bn_mrla.*
    .../downsample/conv/kernel          -> layer{s}.{b}.downsample.0.weight
    .../downsample/bn/*                 -> layer{s}.{b}.downsample.1.*
    .../mrla/mrla/proj/w{q,k} [k]       -> layer{s}.{b}.mrla.mrla.W{q,k}.weight [1,1,k]
    .../mrla/mrla/proj/wv [3,3,1,C]     -> layer{s}.{b}.mrla.mrla.Wv.weight [C,1,3,3]
    .../mrla/lambda_t [C]               -> layer{s}.{b}.mrla.lambda_t [C,1,1]
    params/head/fc/{kernel,bias}        -> fc.{weight,bias}           (kernel transposed)

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
"""

from __future__ import annotations

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


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` (numpy or array leaves) -> state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, p, s):
        for col, leaf, name in _BN_LEAVES:
            sd[f"{prefix}.{name}"] = _t((p if col == "params" else s)[leaf])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = _oihw(params["stem"]["conv1"]["kernel"])
    bn("bn1", params["stem"]["bn1"], stats["stem"]["bn1"])

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
        proj = p["mrla"]["mrla"]["proj"]
        sd[f"{pre}.mrla.mrla.Wq.weight"] = _t(proj["wq"]).reshape(1, 1, -1)
        sd[f"{pre}.mrla.mrla.Wk.weight"] = _t(proj["wk"]).reshape(1, 1, -1)
        sd[f"{pre}.mrla.mrla.Wv.weight"] = _oihw(proj["wv"])
        sd[f"{pre}.mrla.lambda_t"] = _t(p["mrla"]["lambda_t"]).reshape(-1, 1, 1)
        bn(f"{pre}.bn_mrla", p["bn_mrla"], s["bn_mrla"])

    sd["fc.weight"] = _t(np.asarray(params["head"]["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["head"]["fc"]["bias"])
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
