"""MRLA-light block epilogue: the gate in PyTorch, the tail as a CUDA kernel.

    y = out + (dwconv3x3(out) * gate(out)[channel] + λ ⊙ identity)
        * bn_scale + bn_bias

Two phases, as in the JAX package (``mrla_tpu/kernels/mrla_epilogue.py``):
the gate (GAP -> k-tap channel convs -> per-head sigmoid) is a [B, C]
vector computed in PyTorch by ``mrla_light_gate``, and one kernel
(``csrc/mrla_epilogue.cu``) does the depthwise 3x3, gate, λ, BN and residual
with one read of (out, identity) and one write of y: the sliding 3x3 window
of ``csrc/tail_window.cuh`` that the block tail from z also runs, its y bit
for bit the tap loop's (``mrla_tail.cuh:mrla_tail_y8``, which the
mega-tail's y phase still runs).  ``mrla_epilogue_describe`` reports its
launch at a shape (segment, ring, blocks an SM).

Layouts: activations NHWC and contiguous; ``wv`` is the depthwise kernel as
[9, C] fp32, row ``(dh + 1) * 3 + (dw + 1)`` (the JAX [3, 3, 1, C] kernel
reshaped, or the torch [C, 1, 3, 3] weight reshaped to [C, 9] and
transposed); ``lam``, ``bn_scale``, ``bn_bias`` [C] and the gate [B, C] are
fp32.

``fused_epilogue`` launches the kernel for CUDA tensors (bf16 activations)
and runs its plain version ``fused_epilogue_reference`` only for CPU
tensors; any other input raises.  The kernel takes C % 8 == 0; its C entry
point returns cudaErrorInvalidValue (1) otherwise, and the wrapper raises.
``fused_epilogue.counter`` counts calls
and kernel launches, the launches also by (B, H, W, C).

The block tail from the pre-residual map z (``csrc/mrla_block_tail.cu``,
the counterpart of the JAX package's ``mrla_block_tail_pallas``) is the
same tail with ``out = relu(z + identity)`` formed in fp32 inside the
kernel, never stored and never rounded: the taps and the residual use that
fp32 value, while the gate (``mrla_block_tail``) comes from the sum rounded
once to the activation dtype, as in the JAX package.  ``fused_block_tail``
is that kernel given the gate, with the same rules and its own counter.
"""

from __future__ import annotations

import math

import torch

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.ops.common import channel_conv1d, depthwise_conv3x3


def mrla_light_gate(out: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Per-channel sigmoid gate [B, C] fp32 (each head's value repeated over
    its d = C / heads contiguous channels)."""
    b, _, _, c = out.shape
    d = c // heads
    y = torch.mean(out, dim=(1, 2), dtype=torch.float32)
    q = channel_conv1d(y, wq.float()).reshape(b, heads, d)
    k = channel_conv1d(y, wk.float()).reshape(b, heads, d)
    attn = torch.sigmoid((q * k).sum(-1) / math.sqrt(d))
    return attn.repeat_interleave(d, dim=-1)


def check_tail_args(out, identity, gate, wv, lam, bn_scale, bn_bias) -> None:
    """Shape and NHWC-contiguity checks shared by the tail kernels."""
    if out.dim() != 4:
        raise ValueError(f"out must be [B, H, W, C], got {tuple(out.shape)}")
    b, _, _, c = out.shape
    want = {
        "identity": (identity, tuple(out.shape)),
        "gate": (gate, (b, c)),
        "wv": (wv, (9, c)),
        "lam": (lam, (c,)),
        "bn_scale": (bn_scale, (c,)),
        "bn_bias": (bn_bias, (c,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("out", out), ("identity", identity)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous NHWC tensor")


def check_cuda_args(act: dict, vec: dict) -> None:
    """Device, dtype and alignment checks before a tail kernel launch:
    ``act`` are bf16 activations (or weights), ``vec`` fp32 vectors."""
    dev = next(iter(act.values())).device
    for name, t in {**act, **vec}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in act.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, "
                            f"got {t.dtype}")
    for name, t in vec.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def use_plain_version(out: torch.Tensor) -> bool:
    """True for a CPU tensor; False for a CUDA one; raises otherwise."""
    if out.device.type == "cpu":
        return True
    if out.device.type != "cuda":
        raise ValueError(f"no kernel for device {out.device}")
    return False


def _tail_fp32(o, idf, gate, wv, lam, bn_scale, bn_bias) -> torch.Tensor:
    """The tail on fp32 ``o`` and identity ``idf``, unrounded."""
    c = o.shape[-1]
    v = depthwise_conv3x3(o, wv.float().t().reshape(c, 1, 3, 3))
    mrla = v * gate[:, None, None, :] + lam.float() * idf
    return o + mrla * bn_scale.float() + bn_bias.float()


def fused_epilogue_reference(out, identity, gate, wv, lam, bn_scale,
                             bn_bias) -> torch.Tensor:
    """Plain PyTorch version of the kernel (fp32 taps, one rounding of y)."""
    y = _tail_fp32(out.float(), identity.float(), gate, wv, lam, bn_scale,
                   bn_bias)
    return y.to(out.dtype)


def _run_tail_kernel(entry: str, reference, counter: LaunchCounter, x,
                     identity, gate, wv, lam, bn_scale,
                     bn_bias) -> torch.Tensor:
    """Shared by the epilogue and block-tail wrappers: the C entry point
    ``entry`` on CUDA tensors, its launch counted on ``counter`` by
    (B, H, W, C); ``reference`` for CPU tensors."""
    check_tail_args(x, identity, gate, wv, lam, bn_scale, bn_bias)
    if use_plain_version(x):
        return reference(x, identity, gate, wv, lam, bn_scale, bn_bias)
    b, h, w, c = x.shape
    check_cuda_args(
        {"input": x, "identity": identity},
        {"gate": gate, "wv": wv, "lam": lam, "bn_scale": bn_scale,
         "bn_bias": bn_bias},
    )
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(library(), entry)(
            x.data_ptr(), identity.data_ptr(), gate.data_ptr(),
            wv.data_ptr(), lam.data_ptr(), bn_scale.data_ptr(),
            bn_bias.data_ptr(), y.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"{entry} (C={c})")
    counter.launch((b, h, w, c))
    return y


def fused_epilogue(out, identity, gate, wv, lam, bn_scale,
                   bn_bias) -> torch.Tensor:
    """The epilogue kernel given the gate: y [B, H, W, C] like ``out``."""
    fused_epilogue.counter.calls += 1
    return _run_tail_kernel("mrla_epilogue_bf16", fused_epilogue_reference,
                            fused_epilogue.counter, out, identity, gate, wv,
                            lam, bn_scale, bn_bias)


fused_epilogue.counter = LaunchCounter()


def mrla_light_epilogue_reference(out, identity, wq, wk, wv, lam, bn_scale,
                                  bn_bias, heads: int) -> torch.Tensor:
    """Plain version of the whole epilogue, gate included."""
    gate = mrla_light_gate(out, wq, wk, heads)
    return fused_epilogue_reference(out, identity, gate, wv, lam, bn_scale,
                                    bn_bias)


def mrla_light_epilogue(out, identity, wq, wk, wv, lam, bn_scale, bn_bias,
                        heads: int) -> torch.Tensor:
    """The epilogue: gate in PyTorch, then the kernel (counterpart of the
    JAX package's ``mrla_light_epilogue_pallas``)."""
    gate = mrla_light_gate(out, wq, wk, heads)
    return fused_epilogue(out, identity, gate, wv, lam, bn_scale, bn_bias)


def fused_block_tail_reference(z, identity, gate, wv, lam, bn_scale,
                               bn_bias) -> torch.Tensor:
    """Plain version of the block-tail kernel: relu(z + identity) in fp32,
    unrounded, through the taps and the residual; one rounding of y."""
    idf = identity.float()
    y = _tail_fp32(torch.relu(z.float() + idf), idf, gate, wv, lam, bn_scale,
                   bn_bias)
    return y.to(z.dtype)


def run_block_tail(counter: LaunchCounter, z, identity, gate, wv, lam,
                   bn_scale, bn_bias) -> torch.Tensor:
    """The block-tail kernel given the gate, its launch counted on
    ``counter``; the plain version for CPU tensors.  Shared by
    ``fused_block_tail`` and ``mrla_block_tail_hwbc``."""
    return _run_tail_kernel("mrla_block_tail_bf16", fused_block_tail_reference,
                            counter, z, identity, gate, wv, lam, bn_scale,
                            bn_bias)


def fused_block_tail(z, identity, gate, wv, lam, bn_scale,
                     bn_bias) -> torch.Tensor:
    """The block-tail kernel given the gate: y [B, H, W, C] like ``z``."""
    fused_block_tail.counter.calls += 1
    return run_block_tail(fused_block_tail.counter, z, identity, gate, wv,
                          lam, bn_scale, bn_bias)


fused_block_tail.counter = LaunchCounter()


def block_tail_gate(z, identity, wq, wk, heads: int) -> torch.Tensor:
    """The gate of relu(z + identity), the sum rounded once to z's dtype."""
    return mrla_light_gate((z + identity).relu_(), wq, wk, heads)


def mrla_block_tail(z, identity, wq, wk, wv, lam, bn_scale, bn_bias,
                    heads: int) -> torch.Tensor:
    """The block tail from z: gate in PyTorch, then the kernel (counterpart
    of the JAX package's ``mrla_block_tail_pallas``, without its W % 8 and
    C % 128 gates: any B, H, W and C % 8 == 0)."""
    gate = block_tail_gate(z, identity, wq, wk, heads)
    return fused_block_tail(z, identity, gate, wv, lam, bn_scale, bn_bias)
