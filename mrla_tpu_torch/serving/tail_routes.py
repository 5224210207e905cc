"""resnet50_mrlal serving with every block's tail sent down one of three
routes: the port of the JAX package's in-model tail harness.

The JAX package's A/B scripts rebuild the BN-folded serving forward from
the engine's ``_stem`` / ``_conv`` and its serving params, and swap the
block tail for a kernel under test: ``scripts/exp_tail.py:forward`` (its
``rowtail`` mode sends every block through ``mrla_rowtail``) and
``scripts/exp_boundary.py:fwd_with_copies`` (a copy kernel after each of the
first blocks).  :func:`resnet_mrlal_tail_forward` is their counterpart on
the port's engine (``serving/resnet_mrlal.py``: the same ``_stem``,
``_conv``, params and head), and runs the kernels that no entry point of
either package calls:

  * ``"rowtail"``: every block's tail is ``mrla_rowtail`` on relu(z + id);
    a block with a next block also computes that block's conv1 inside the
    kernel, and the next block starts from that activation.  exp_tail's
    rule that C1 be at least 128 (TPU lane padding) is not carried over;
  * ``"block_tail"``: every block's tail from z; blocks whose map is at
    least ``HWBC_MIN_W`` wide go through ``mrla_block_tail_hwbc``, the rest
    through ``mrla_block_tail``, as the JAX engine's ``hwbc_min_w=28``
    splits them;
  * ``"copy"``: the ``"block_tail"`` route with ``hwbc_copy`` after each of
    the first ``COPY_BLOCKS`` blocks (exp_boundary's ``ncopy=3``, stage 1);
    its logits equal the ``"block_tail"`` route's bit for bit.

``resnet_mrlal_forward`` and its routing stay as they are.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from mrla_tpu_torch.kernels.mrla_epilogue import (
    mrla_block_tail,
    mrla_light_gate,
)
from mrla_tpu_torch.kernels.mrla_epilogue_hwbc import (
    hwbc_copy,
    mrla_block_tail_hwbc,
)
from mrla_tpu_torch.kernels.mrla_rowtail import mrla_rowtail
from mrla_tpu_torch.serving.resnet_mrlal import _conv, _head_impl, _stem

TAILS = ("rowtail", "block_tail", "copy")
HWBC_MIN_W = 28
COPY_BLOCKS = 3


def _strides(layers: Sequence[int]) -> list:
    return [2 if (stage > 0 and b == 0) else 1
            for stage, n in enumerate(layers) for b in range(n)]


@torch.inference_mode()
def resnet_mrlal_tail_forward(
    serving_params: Dict,
    x: torch.Tensor,
    tail: str,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 32,
) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32, every block's tail routed
    by ``tail`` (one of ``TAILS``)."""
    if tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {tail!r}")
    stem = serving_params["stem"]
    if x.device != stem["k"].device:
        raise ValueError(f"images are on {x.device}, params on "
                         f"{stem['k'].device}")
    blocks = serving_params["blocks"]
    strides = _strides(layers)
    if len(blocks) != len(strides):
        raise ValueError(
            f"serving params hold {len(blocks)} blocks but layers="
            f"{tuple(layers)} implies {len(strides)}"
        )
    y = _stem(x.to(stem["k"].dtype), stem)
    x1_pre = None
    for i, (p, stride) in enumerate(zip(blocks, strides)):
        heads = p["lam"].shape[0] // dim_perhead
        out = (x1_pre if x1_pre is not None
               else _conv(y, p["k1"], p["b1"]).relu_())
        out = _conv(out, p["k2"], p["b2"], stride=stride).relu_()
        z = _conv(out, p["k3"], p["b3"])
        identity = (_conv(y, p["kd"], p["bd"], stride=stride) if "kd" in p
                    else y)
        vecs = (p["wv"], p["lam"], p["bn_scale"], p["bn_bias"])
        if tail == "rowtail":
            # relu(z + id), in place: one rounding of the sum
            out = z.add_(identity).relu_()
            gate = mrla_light_gate(out, p["wq"], p["wk"], heads)
            if i + 1 < len(blocks):
                nxt = blocks[i + 1]
                y, x1_pre = mrla_rowtail(out, identity, gate, *vecs,
                                         nxt["k1"], nxt["b1"])
            else:
                y = mrla_rowtail(out, identity, gate, *vecs)
            continue
        block_tail = (mrla_block_tail_hwbc if z.shape[2] >= HWBC_MIN_W
                      else mrla_block_tail)
        y = block_tail(z, identity, p["wq"], p["wk"], *vecs, heads)
        if tail == "copy" and i < COPY_BLOCKS:
            y = hwbc_copy(y)
    return _head_impl(serving_params, y)
