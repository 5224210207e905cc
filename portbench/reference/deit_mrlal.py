"""Plain PyTorch reference of DeiT (arXiv:2012.12877) with the MRLA-light
token tail in every block (arXiv:2302.03985, the reference
implementation's ``deit/`` models), on the state dict the benchmark draws.

    block:  ot = x
            x  = x + dp(proj(attention(LN1 x)))         pre-norm ViT block
            x  = x + dp(fc2(gelu(fc1(LN2 x))))           exact-erf GELU
            nx, no = LN_x(x), LN_o(ot)                   eps 1e-6
            g  = per-head sigmoid(q . k / sqrt(d)), q and k the k-tap
                 channel convs Wq, Wk of the mean of nx over the grid rows
            grid rows:  x += gelu(dwconv3x3(nx on the s x s grid; Wv)) * g
                             + lambda * no
            cls row:    x += nx                          (no MRLA term)

with a 16 x 16 stride-16 patch embedding, the cls token and the position
embedding in front, and the head fc(LN(cls row)).  Attention: softmax of
q k^T / sqrt(head dim) over the tokens, float32.  ``dp`` is stochastic
depth at rate ``drop_path * i / (depth - 1)`` in block i, training only:
one uniform a sample from the benchmark's generator for the attention
branch, then one for the MLP branch, block by block.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import common, init
from portbench.reference.common import FP32, Precision

LN_EPS = 1e-6
HEAD = "head.weight"  # the output layer's weight
NO_DECAY = ("pos_embed", "cls_token", "dist_token")
NO_DECAY_SUFFIX = ("Wq.weight", "Wk.weight", "lambda_t")


def spec(cfg: dict) -> init.Spec:
    """The state dict's leaves and init rules, spread as a trained
    model's are: qkv / proj / fc1 / fc2 weights N(0, 1 / fan_in) (each
    keeps its input's variance), their biases N(0, 0.02), LayerNorm scales
    U(0.5, 1.5) and biases N(0, 0.5), the tail's taps U(-2, 2) and
    depthwise weights N(0, 0.5), lambda N(0, 1), the head N(0, 0.05); the
    patch embedding, cls token and position embedding keep the init's
    truncated N(0, 0.02)."""
    c, p, n = cfg["embed_dim"], cfg["patch_size"], cfg["image_size"]
    tokens = 1 + (n // p) ** 2
    hidden = int(c * cfg["mlp_ratio"])
    k = common.eca_kernel_size(c)

    def lin(name, o, i):
        return [(f"{name}.weight", (o, i), ("normal", 0.0, i ** -0.5)),
                (f"{name}.bias", (o,), ("normal", 0.0, 0.02))]

    def ln(name):
        return [(f"{name}.weight", (c,), ("uniform", 0.5, 1.5)),
                (f"{name}.bias", (c,), ("normal", 0.0, 0.5))]

    out: init.Spec = [
        ("cls_token", (1, 1, c), ("trunc", 0.0, 0.02)),
        ("pos_embed", (1, tokens, c), ("trunc", 0.0, 0.02)),
        ("patch_embed.proj.weight", (c, 3, p, p), ("trunc", 0.0, 0.02)),
        ("patch_embed.proj.bias", (c,), ("normal", 0.0, 0.02))]
    for i in range(cfg["depth"]):
        pre = f"blocks.{i}"
        out += ln(f"{pre}.norm1") + lin(f"{pre}.attn.qkv", 3 * c, c)
        out += lin(f"{pre}.attn.proj", c, c) + ln(f"{pre}.norm2")
        out += lin(f"{pre}.mlp.fc1", hidden, c) + lin(f"{pre}.mlp.fc2", c,
                                                       hidden)
        out += ln(f"{pre}.mrla.normx") + ln(f"{pre}.mrla.normo")
        out += [(f"{pre}.mrla.mrla.Wq.weight", (1, 1, k),
                 ("uniform", -2.0, 2.0)),
                (f"{pre}.mrla.mrla.Wk.weight", (1, 1, k),
                 ("uniform", -2.0, 2.0)),
                (f"{pre}.mrla.mrla.Wv.weight", (c, 1, 3, 3),
                 ("normal", 0.0, 0.5)),
                (f"{pre}.mrla.lambda_t", (c,), ("normal", 0.0, 1.0))]
    out += ln("norm")
    out += [("head.weight", (cfg["num_classes"], c), ("normal", 0.0, 0.05)),
            ("head.bias", (cfg["num_classes"],), ("normal", 0.0, 0.02))]
    return out


def calibrate(sd, cfg, images) -> None:
    """Nothing to calibrate: LayerNorm keeps no statistics."""


def _ln(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], LN_EPS)


def _net(sd: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
         q: Precision, drop_path: float = 0.0, gen=None) -> torch.Tensor:
    c, heads, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch_size"]
    d = c // heads
    x = common.conv2d(q, images.float().permute(0, 3, 1, 2),
                      sd["patch_embed.proj.weight"],
                      sd["patch_embed.proj.bias"], stride=p)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["cls_token"].expand(b, -1, -1), x], 1) + sd["pos_embed"]
    n = x.shape[1]
    s = math.isqrt(n - 1)
    depth = cfg["depth"]
    for i in range(depth):
        pre = f"blocks.{i}"
        rate = drop_path * i / max(1, depth - 1)
        ot = x
        qkv = common.linear(q, _ln(x, sd, f"{pre}.norm1"),
                            sd[f"{pre}.attn.qkv.weight"],
                            sd[f"{pre}.attn.qkv.bias"])
        qh, kh, vh = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        logits = q.out(torch.matmul(q(qh), q(kh).transpose(-2, -1))
                       ) / math.sqrt(d)
        a = q.out(torch.matmul(q(torch.softmax(logits, -1)), q(vh)))
        a = common.linear(q, a.transpose(1, 2).reshape(b, n, c),
                          sd[f"{pre}.attn.proj.weight"],
                          sd[f"{pre}.attn.proj.bias"])
        x = x + common.drop_path(a, rate, gen)
        h = common.linear(q, _ln(x, sd, f"{pre}.norm2"),
                          sd[f"{pre}.mlp.fc1.weight"], sd[f"{pre}.mlp.fc1.bias"])
        h = common.linear(q, F.gelu(h), sd[f"{pre}.mlp.fc2.weight"],
                          sd[f"{pre}.mlp.fc2.bias"])
        x = x + common.drop_path(h, rate, gen)
        nx = _ln(x, sd, f"{pre}.mrla.normx")
        no = _ln(ot, sd, f"{pre}.mrla.normo")
        grid = nx[:, 1:]
        gate = common.head_gate(grid.mean(1), sd[f"{pre}.mrla.mrla.Wq.weight"],
                                sd[f"{pre}.mrla.mrla.Wk.weight"],
                                c // cfg["dim_mrla"])
        v = common.conv2d(q, grid.transpose(1, 2).reshape(b, c, s, s),
                          sd[f"{pre}.mrla.mrla.Wv.weight"], padding=1,
                          groups=c)
        v = F.gelu(v).reshape(b, c, n - 1).transpose(1, 2)
        tail = v * gate[:, None, :] + sd[f"{pre}.mrla.lambda_t"] * no[:, 1:]
        x = x + torch.cat([nx[:, :1], tail], 1)
    return common.linear(q, _ln(x[:, 0], sd, "norm"), sd["head.weight"],
                         sd["head.bias"])


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            q: Precision = FP32) -> torch.Tensor:
    """Eval-mode logits [B, classes] fp32 of NHWC ``images``."""
    with common.exact_fp32():
        return _net(sd, cfg, images, q)


def train_loss(params, sd, cfg, images, targets, gen, recipe: dict,
               q: Precision = FP32) -> torch.Tensor:
    """The training loss of one batch: the forward with the recipe's
    stochastic depth (masks from ``gen``), soft-target cross entropy.
    ``params`` take the place of their entries of ``sd``."""
    logits = _net({**sd, **params}, cfg, images, q,
                  recipe.get("drop_path", 0.0), gen)
    return common.soft_ce(logits, targets)


def decayed(name: str, p: torch.Tensor) -> bool:
    """timm's rule for AdamW: leaves of rank 2 or more, less the tokens,
    the position embedding and MRLA's channel taps and lambda."""
    if name.rsplit(".", 1)[-1] in NO_DECAY or name.endswith(NO_DECAY_SUFFIX):
        return False
    return p.ndim >= 2
