"""The last stage of resnet50_mrlal after ``layer4_0``'s conv2, as one call.

Counterpart of the JAX package's ``mrla_tpu/kernels/mrla_stage4.py``
(``stage4_resident``), whose TPU kernel this module's CUDA kernel
(``csrc/mrla_stage4.cu``) replaces.  From

    ob = relu(conv2(relu(conv1(x))))     [B, 7, 7, C1]   of block layer4_0
    xs = x[:, ::2, ::2, :]               [B, 7, 7, CIN]  (the downsample's taps)

it computes the stage output [B, 7, 7, C]; rows are the B * 49 pixels:

    id0 = xs @ kd + bd ; z0 = ob @ k3_0 + b3_0 ; y = tail(relu(z0 + id0), id0, 0)
    for blk in 1, 2:
        x1 = relu(y @ k1 + b1)
        o  = relu(conv3x3(x1, k2) + b2)
        z  = o @ k3 + b3
        y  = tail(relu(z + y), y, blk)
    tail(out, id, blk) = out + (dwconv3x3(out) * gate(out) + lam * id)
                         * bn_scale + bn_bias

Rounding points (both the kernel and the plain version keep them): product
operands are in the compute dtype (the packed weights' dtype) and sums in
fp32; ``z``, ``id0``, ``out`` and ``y`` are fp32 from block to block, so the
identity of blocks 1 and 2 is the unrounded ``y``; ``x1`` and ``o`` are
rounded to the compute dtype once; biases are fp32; the last ``y`` is
rounded once to the dtype of ``ob``.  The gate sums each head's channels
of q * k in fp32, as ``mrla_light_gate`` does.

Bound on an H100 at the published widths (CIN 1024, C1 512, C 2048) and
batch 128: operations, 151 GFLOP of bf16 products, 0.153 ms at the
tensor-core peak, against 69 MB of weights, inputs and output, 0.021 ms.
The kernel therefore tiles every product over all SMs: eight launches of
one persistent, warp-specialised product kernel (TMA into a ring of
stages, two consumer warpgroups in turns), the block tails inside the z
products' epilogues, intermediates in scratch that this wrapper allocates
(``scratch``); see the source's header.

``pack_stage4_params`` lays the three blocks' serving params out as the
kernel wants them: product weights as [N, K] matrices with K contiguous
(the 3x3 weight as [C1, 9 * C1], tap-major), per-channel vectors fp32.
``stage4_resident`` launches the kernel for CUDA tensors (bf16) and runs
the plain version ``stage4_resident_reference`` only for CPU tensors; any
other input raises.  ``xs`` may be a strided view of the parent map (its
channels contiguous): the kernel reads it in place.  The kernel takes
C % 128 == 0, C1 % 128 == 0, CIN % 64 == 0, heads of d channels with
128 % d == 0 and an odd ktap <= 9; its C entry point returns
cudaErrorInvalidValue (1) for anything else, and the wrapper raises.
``stage4_resident.counter`` counts calls and launches, the launches also by
(B, CIN, C1, C).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import (
    check_cuda_args,
    fused_epilogue_reference,
    mrla_light_gate,
    use_plain_version,
)

HW = 7
SP = HW * HW  # rows per image

_WEIGHTS = ("kd", "k3_0", "k1", "k2", "k3")
_VECTORS = ("bd", "b3_0", "b1", "b2", "b3", "wq", "wk", "wv", "lam",
            "bn_scale", "bn_bias")


def pack_stage4_params(blocks: Sequence[Dict], dtype: torch.dtype,
                       dim_perhead: int = 32) -> Dict:
    """``blocks``: the three stage-4 entries [b0, b1, b2] of the serving
    params (``prepare_inference_params``: conv weights [out, in, kh, kw],
    ``wv`` [9, C]).  Returns the operands of :func:`stage4_resident`:

        kd [C, CIN], k3_0 [C, C1]                       block 0, ``dtype``
        k1 [2, C1, C], k2 [2, C1, 9 * C1], k3 [2, C, C1]  blocks 1, 2
        bd, b3_0 [C]; b1, b2 [2, C1]; b3 [2, C]         fp32
        wq, wk [3, ktap]; wv [3, 9, C]; lam, bn_scale, bn_bias [3, C]  fp32
        heads = C // dim_perhead
    """
    b0, b1, b2 = blocks
    c, c1 = b0["k3"].shape[:2]

    def mat(k):  # [out, in, kh, kw] -> [out, kh * kw * in]
        return k.permute(0, 2, 3, 1).reshape(k.shape[0], -1).to(dtype)

    def stack(name, ps, as_matrix=False):
        ts = [mat(p[name]) if as_matrix else p[name].float().reshape(-1)
              for p in ps]
        return torch.stack(ts).contiguous()

    packed = {
        "kd": mat(b0["kd"]).contiguous(),
        "k3_0": mat(b0["k3"]).contiguous(),
        "bd": b0["bd"].float().contiguous(),
        "b3_0": b0["b3"].float().contiguous(),
        "wv": torch.stack([p["wv"].float().reshape(9, c)
                           for p in blocks]).contiguous(),
        "heads": c // dim_perhead,
    }
    for name in ("k1", "k2", "k3"):
        packed[name] = stack(name, (b1, b2), as_matrix=True)
    for name in ("b1", "b2", "b3"):
        packed[name] = stack(name, (b1, b2))
    for name in ("wq", "wk", "lam", "bn_scale", "bn_bias"):
        packed[name] = stack(name, blocks)
    if packed["k2"].shape != (2, c1, 9 * c1):
        raise ValueError(f"conv2 of blocks 1 and 2 must be 3x3 on {c1} "
                         f"channels, got {tuple(b1['k2'].shape)}")
    return packed


def _check_args(ob, xs, packed) -> tuple[int, int, int, int]:
    if ob.dim() != 4 or xs.dim() != 4:
        raise ValueError("ob and xs must be [B, 7, 7, channels]")
    b, c1 = ob.shape[0], ob.shape[-1]
    cin = xs.shape[-1]
    c = packed["kd"].shape[0]
    ktap = packed["wq"].shape[-1]
    want = {
        "ob": (ob, (b, HW, HW, c1)), "xs": (xs, (b, HW, HW, cin)),
        "kd": (packed["kd"], (c, cin)), "k3_0": (packed["k3_0"], (c, c1)),
        "k1": (packed["k1"], (2, c1, c)),
        "k2": (packed["k2"], (2, c1, 9 * c1)),
        "k3": (packed["k3"], (2, c, c1)),
        "bd": (packed["bd"], (c,)), "b3_0": (packed["b3_0"], (c,)),
        "b1": (packed["b1"], (2, c1)), "b2": (packed["b2"], (2, c1)),
        "b3": (packed["b3"], (2, c)),
        "wq": (packed["wq"], (3, ktap)), "wk": (packed["wk"], (3, ktap)),
        "wv": (packed["wv"], (3, 9, c)), "lam": (packed["lam"], (3, c)),
        "bn_scale": (packed["bn_scale"], (3, c)),
        "bn_bias": (packed["bn_bias"], (3, c)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not ob.is_contiguous():
        raise ValueError("ob must be a contiguous NHWC tensor")
    if xs.stride(3) != 1:
        raise ValueError("xs must have contiguous channels")
    return b, cin, c1, c


def stage4_resident_reference(ob: torch.Tensor, xs: torch.Tensor,
                              packed: Dict) -> torch.Tensor:
    """Plain PyTorch version, with the rounding points of the module's
    docstring.  Products run as fp32 matmuls of the compute-dtype operands
    (exact products, fp32 sums)."""
    b, cin, c1, c = _check_args(ob, xs, packed)
    cd = packed["kd"].dtype
    heads = packed["heads"]

    def mm(a, w):  # [rows, K] compute dtype @ [N, K]^T -> fp32
        return a.to(cd).float() @ w.float().t()

    def tail(out, identity, blk):
        out4, id4 = out.reshape(b, HW, HW, c), identity.reshape(b, HW, HW, c)
        gate = mrla_light_gate(out4, packed["wq"][blk], packed["wk"][blk],
                               heads)
        y = fused_epilogue_reference(
            out4, id4, gate, packed["wv"][blk], packed["lam"][blk],
            packed["bn_scale"][blk], packed["bn_bias"][blk])
        return y.reshape(b * SP, c)

    z0 = mm(ob.reshape(b * SP, c1), packed["k3_0"]) + packed["b3_0"]
    id0 = mm(xs.reshape(b * SP, cin), packed["kd"]) + packed["bd"]
    y = tail(torch.relu(z0 + id0), id0, 0)
    for i in range(2):
        x1 = torch.relu(mm(y, packed["k1"][i]) + packed["b1"][i]).to(cd)
        k2 = packed["k2"][i].float().reshape(c1, 3, 3, c1).permute(0, 3, 1, 2)
        o = F.conv2d(x1.float().reshape(b, HW, HW, c1).permute(0, 3, 1, 2),
                     k2, packed["b2"][i], padding=1)
        o = torch.relu(o).permute(0, 2, 3, 1).reshape(b * SP, c1).to(cd)
        z = mm(o, packed["k3"][i]) + packed["b3"][i]
        y = tail(torch.relu(z + y), y, i + 1)
    return y.reshape(b, HW, HW, c).to(ob.dtype)


def scratch(b: int, c1: int, c: int, device) -> Dict[str, torch.Tensor]:
    """The kernel's scratch at batch b: two fp32 [B * 49, C] buffers (id0
    and the blocks' y, each block's y in the buffer its identity is not
    in), y in bf16, and x1 and o in bf16."""
    m = b * SP
    return {"f32": torch.empty((2, m, c), dtype=torch.float32, device=device),
            "yb": torch.empty((m, c), dtype=torch.bfloat16, device=device),
            "x1o": torch.empty((2, m, c1), dtype=torch.bfloat16,
                               device=device)}


def entry_args(ob, xs, packed, scratch: Dict[str, torch.Tensor],
               y: torch.Tensor) -> tuple:
    """The arguments of the C entry point ``mrla_stage4_bf16`` but the
    stream, writing the stage output into y."""
    b, c1 = ob.shape[0], ob.shape[-1]
    ptr = lambda name: packed[name].data_ptr()
    return (ob.data_ptr(), xs.data_ptr(), xs.stride(0), xs.stride(1),
            xs.stride(2), ptr("kd"), ptr("k3_0"), ptr("k1"), ptr("k2"),
            ptr("k3"), ptr("bd"), ptr("b3_0"), ptr("b1"), ptr("b2"),
            ptr("b3"), ptr("wq"), ptr("wk"), ptr("wv"), ptr("lam"),
            ptr("bn_scale"), ptr("bn_bias"), scratch["f32"].data_ptr(),
            scratch["yb"].data_ptr(), scratch["x1o"].data_ptr(),
            y.data_ptr(), b, xs.shape[-1], c1, packed["kd"].shape[0],
            packed["heads"], packed["wq"].shape[-1])


def stage4_resident(ob: torch.Tensor, xs: torch.Tensor,
                    packed: Dict) -> torch.Tensor:
    """The stage output [B, 7, 7, C] in the dtype of ``ob``."""
    counter = stage4_resident.counter
    counter.calls += 1
    b, cin, c1, c = _check_args(ob, xs, packed)
    if use_plain_version(ob):
        return stage4_resident_reference(ob, xs, packed)
    if xs.data_ptr() % 16 or any(s % 8 for s in xs.stride()[:3]):
        raise ValueError("xs must be 16-byte aligned with pixel strides "
                         "that are multiples of 8 values")
    check_cuda_args(
        {"ob": ob, **{k: packed[k] for k in _WEIGHTS}},
        {k: packed[k] for k in _VECTORS},
    )
    if xs.device != ob.device or xs.dtype != torch.bfloat16:
        raise TypeError(f"xs must be bfloat16 on {ob.device}, got "
                        f"{xs.dtype} on {xs.device}")
    y = torch.empty((b, HW, HW, c), dtype=ob.dtype, device=ob.device)
    buffers = scratch(b, c1, c, ob.device)
    with torch.cuda.device(ob.device):
        err = library().mrla_stage4_bf16(
            *entry_args(ob, xs, packed, buffers, y),
            torch.cuda.current_stream().cuda_stream)
    check(err, f"mrla_stage4_bf16 (CIN={cin}, C1={c1}, C={c})")
    counter.launch((b, cin, c1, c))
    return y


stage4_resident.counter = LaunchCounter()
