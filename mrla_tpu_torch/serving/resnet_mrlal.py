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
    whose output map is at least ``MEGATAIL_MIN_W`` wide, which has a next
    block, and whose (C, next C1) the mega-tail covers (``megatail_covers``:
    not stage 4's C = 2048, nor a next conv1 of 512) goes through the
    mega-tail (``kernels/mrla_megatail.py``), which also computes the next
    block's conv1; the next block then starts from that activation, across
    a stage boundary too.  Every other block goes through the epilogue
    kernel (``kernels/mrla_epilogue.py``), and the next conv1 stays a
    convolution;
  * with ``use_stage4=True`` and params from :func:`attach_stage4`, a final
    stage of three blocks on a 7x7 map runs from ``layer4_0``'s conv2 to the
    stage output in the stage kernel (``kernels/mrla_stage4.py``).  Any
    other geometry takes the per-block kernels: routing by shape, which the
    wrappers' counters show.

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
from mrla_tpu_torch.kernels.mrla_megatail import (
    megatail_covers,
    mrla_block_tail_fused_next,
)
from mrla_tpu_torch.kernels.mrla_stage4 import (
    pack_stage4_params,
    stage4_resident,
)
from mrla_tpu_torch.ops.common import conv2d_nhwc as _conv
from mrla_tpu_torch.ops.common import max_pool_same_torch
from mrla_tpu_torch.serving.microbatch import chains

BN_EPS = 1e-5
MEGATAIL_MIN_W = 28


def _bn_affine(sd: Mapping, prefix: str):
    s = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + BN_EPS)
    return s, sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * s


def _float_state_dict(model_or_state_dict) -> Dict[str, torch.Tensor]:
    """A model's or a state_dict's tensors as fp32 CPU copies, without a
    ``module.`` prefix or BN ``num_batches_tracked`` entries."""
    src = (model_or_state_dict.state_dict()
           if isinstance(model_or_state_dict, nn.Module)
           else model_or_state_dict)
    return {k.removeprefix("module."): v.detach().to("cpu", torch.float32)
            for k, v in src.items() if not k.endswith("num_batches_tracked")}


def _folded_conv(sd: Mapping, kernel_key: str, bn_prefix: str, dev,
                 dtype: torch.dtype):
    """(kernel · BN scale, BN bias) in ``dtype`` on ``dev``; the kernel
    channels_last."""
    s, b = _bn_affine(sd, bn_prefix)
    k = sd[kernel_key] * s[:, None, None, None]
    return (k.to(dev, dtype).contiguous(memory_format=torch.channels_last),
            b.to(dev, dtype))


def _check_layers(sd: Mapping, layers: Sequence[int]) -> None:
    """Every layer{s}.{b} block must be consumed: a subset would serve a
    truncated network with valid shapes."""
    expect = {f"layer{s + 1}.{b}" for s, n in enumerate(layers)
              for b in range(n)}
    have = {".".join(k.split(".")[:2]) for k in sd if k.startswith("layer")}
    if have != expect:
        raise ValueError(
            f"layers={tuple(layers)} does not match the state_dict: "
            f"missing={sorted(expect - have)[:3]} "
            f"extra={sorted(have - expect)[:3]}"
        )


def prepare_inference_params(
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    layers: Sequence[int] = (3, 4, 6, 3),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    with_head: bool = True,
    s2d: bool = False,
) -> Dict:
    """Fold BNs and cast; returns the serving params on ``device``.

    ``with_head=False`` leaves the fc out (a features-only backbone).
    ``s2d=True`` also packs the stem's 7x7 stride-2 kernel as an equivalent
    4x4 stride-1 kernel on a space-to-depth input (2x2 pixel blocks moved
    into 12 channels), which ``_stem`` takes for even-sized images."""
    dev = resolve_device(device)
    sd = _float_state_dict(model_or_state_dict)
    conv = lambda kernel_key, bn_prefix: _folded_conv(
        sd, kernel_key, bn_prefix, dev, dtype)

    def vec(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev, torch.float32).contiguous()

    _check_layers(sd, layers)

    out: Dict = {}
    k, b = conv("conv1.weight", "bn1")
    out["stem"] = {"k": k, "b": b}
    if s2d:
        # w4[o, (py, px, c), I, J] = w7[o, c, 2I + py, 2J + px], zero where
        # 2I + py or 2J + px exceeds 6
        w7 = F.pad(k.float(), (0, 1, 0, 1))  # [O, 3, 8, 8]
        o = w7.shape[0]
        w4 = w7.reshape(o, 3, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        out["stem"]["k_s2d"] = w4.reshape(o, 12, 4, 4).to(dtype).contiguous(
            memory_format=torch.channels_last)
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

    if with_head:
        out["fc"] = {"k": sd["fc.weight"].to(dev, dtype),  # [classes, C]
                     "b": vec(sd["fc.bias"])}
    return out


def attach_stage4(serving_params: Dict,
                  layers: Sequence[int] = (3, 4, 6, 3),
                  dim_perhead: int = 32) -> Dict:
    """Pack the final stage's params for the stage kernel
    (``kernels/mrla_stage4.py``) and attach them under ``"stage4"``.

    The route is opt-in (``use_stage4=True`` in
    :func:`resnet_mrlal_forward`); only a final stage of three blocks
    qualifies.  Returns the same dict for chaining."""
    if layers[-1] != 3:
        raise ValueError("stage4 kernel covers 3-block final stages only")
    blocks = serving_params["blocks"][-3:]
    if "kd" not in blocks[0]:
        raise ValueError("final-stage entry block has no downsample")
    serving_params["stage4"] = pack_stage4_params(
        blocks, dtype=blocks[0]["k3"].dtype, dim_perhead=dim_perhead)
    return serving_params


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
    if (out.shape[2] >= MEGATAIL_MIN_W and p_next is not None
            and megatail_covers(out.shape[3], p_next["k1"].shape[0])):
        gate = mrla_light_gate(out, p["wq"], p["wk"], heads)
        return mrla_block_tail_fused_next(
            out, identity, gate, p["wv"], p["lam"], p["bn_scale"],
            p["bn_bias"], p_next["k1"], p_next["b1"],
        )
    return mrla_light_epilogue(
        out, identity, p["wq"], p["wk"], p["wv"], p["lam"], p["bn_scale"],
        p["bn_bias"], heads,
    ), None


def _stem(x: torch.Tensor, p: Dict) -> torch.Tensor:
    b, h, w, c = x.shape
    if "k_s2d" in p and h % 2 == 0 and w % 2 == 0:
        # space-to-depth: pad 3 -> [H + 6, W + 6]; 2x2 blocks into channels
        # -> [(H + 6) / 2, (W + 6) / 2, 12]; a 4x4 conv without padding then
        # equals the 7x7 stride-2 conv
        xp = F.pad(x, (0, 0, 3, 3, 3, 3))
        hp, wp = h + 6, w + 6
        xp = xp.reshape(b, hp // 2, 2, wp // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(b, hp // 2, wp // 2, 4 * c)
        y = F.conv2d(xp.permute(0, 3, 1, 2), p["k_s2d"], p["b"])
        y = y.permute(0, 2, 3, 1).relu_()
    else:
        y = _conv(x, p["k"], p["b"], stride=2).relu_()
    return max_pool_same_torch(y, 3, 2)


def _blocks_impl(serving_params: Dict, y: torch.Tensor,
                 layers: Sequence[int], dim_perhead: int,
                 use_stage4: bool = False) -> list:
    """All blocks on a post-stem map; the per-stage outputs [C2, ..]."""
    strides, stage_last = [], []
    for stage_idx, n in enumerate(layers):
        strides += [2 if (stage_idx > 0 and b == 0) else 1 for b in range(n)]
        stage_last.append(len(strides) - 1)
    blocks = serving_params["blocks"]
    if len(blocks) != len(strides):
        raise ValueError(
            f"serving params hold {len(blocks)} blocks but layers="
            f"{tuple(layers)} implies {len(strides)}"
        )
    # the final stage's map: every later stage halves the post-stem map
    # (symmetric padding, so ceil(h / 2))
    s4_h, s4_w = y.shape[1], y.shape[2]
    for _ in layers[1:]:
        s4_h, s4_w = -(-s4_h // 2), -(-s4_w // 2)
    s4_start = len(strides) - layers[-1]
    run_s4 = (use_stage4 and "stage4" in serving_params and layers[-1] == 3
              and strides[s4_start] == 2 and (s4_h, s4_w) == (7, 7))
    x1_pre = None
    outs = []
    for i, (p, stride) in enumerate(zip(blocks, strides)):
        if run_s4 and i == s4_start:
            # layer4_0's conv1 and stride-2 conv2 stay convolutions; the
            # stage kernel runs everything after them
            x1 = (x1_pre if x1_pre is not None
                  else _conv(y, p["k1"], p["b1"]).relu_())
            ob = _conv(x1, p["k2"], p["b2"], stride=stride).relu_()
            outs.append(stage4_resident(ob.contiguous(), y[:, ::2, ::2, :],
                                        serving_params["stage4"]))
            break
        heads = p["lam"].shape[0] // dim_perhead
        p_next = blocks[i + 1] if i + 1 < len(blocks) else None
        # the conv1 hand-off stays valid across stage boundaries: conv1 is
        # stride 1 and consumes exactly this block's output y
        y, x1_pre = _block(y, p, stride, heads, x1_pre=x1_pre, p_next=p_next)
        if i in stage_last:
            outs.append(y)
    return outs


def _check_device(x: torch.Tensor, param: torch.Tensor) -> None:
    if x.device != param.device:
        raise ValueError(f"images are on {x.device}, params on "
                         f"{param.device}")


def _trunk_impl(serving_params: Dict, x: torch.Tensor,
                layers: Sequence[int], dim_perhead: int,
                use_stage4: bool = False) -> list:
    """Stem and all blocks; the per-stage outputs [C2, C3, C4, C5]."""
    stem = serving_params["stem"]
    _check_device(x, stem["k"])
    y = _stem(x.to(stem["k"].dtype), stem)
    return _blocks_impl(serving_params, y, layers, dim_perhead, use_stage4)


def _head_impl(serving_params: Dict, y: torch.Tensor) -> torch.Tensor:
    pooled = torch.mean(y, dim=(1, 2), dtype=torch.float32)
    fc = serving_params["fc"]
    return pooled @ fc["k"].float().t() + fc["b"]


@torch.inference_mode()
def resnet_mrlal_forward(
    serving_params: Dict,
    x: torch.Tensor,
    layers: Sequence[int] = (3, 4, 6, 3),
    dim_perhead: int = 32,
    use_stage4: bool = False,
    microbatch: int = 0,
    shared_stem: bool = True,
) -> torch.Tensor:
    """[B, H, W, 3] images (any float dtype; cast to the param dtype) on the
    params' device -> logits [B, classes] fp32.

    ``use_stage4=True`` sends the final stage through the stage kernel when
    the params carry ``"stage4"`` (:func:`attach_stage4`) and the stage's map
    is 7x7 (224 px images); otherwise the per-block kernels run.

    ``microbatch`` > 0 serves the batch as chains of that many images, one
    after another (``serving/microbatch.py``; 0, the default, serves it
    unsplit).  With ``shared_stem`` the stem and max pool run on the whole
    batch and the chains start after them; the head takes the chains'
    maps together."""
    parts = chains(x, microbatch)
    if parts is None:
        y = _trunk_impl(serving_params, x, layers, dim_perhead,
                        use_stage4)[-1]
    else:
        trunk = _trunk_impl
        if shared_stem:
            stem = serving_params["stem"]
            _check_device(x, stem["k"])
            parts = _stem(x.to(stem["k"].dtype), stem).split(microbatch)
            trunk = _blocks_impl
        y = torch.cat([trunk(serving_params, part, layers, dim_perhead,
                             use_stage4)[-1] for part in parts])
    return _head_impl(serving_params, y)
