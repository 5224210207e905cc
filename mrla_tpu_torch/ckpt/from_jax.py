"""JAX/Flax variables -> the port's ``state_dict`` (resnet mrlal family).

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
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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
