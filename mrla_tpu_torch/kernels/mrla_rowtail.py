"""MRLA-light row tail, optionally with the next block's 1x1 conv.

    gs = gate·bn_scale,  ls = λ·bn_scale                  (fp32, in PyTorch)
    y  = out + dwconv3x3(out)·gs + ls·id + bn_bias        (in this order)
    x1 = relu(bf16(y) @ W1 + b1)                          (with ``w1_next``)

The counterpart of the JAX package's ``mrla_rowtail``
(``mrla_tpu/kernels/mrla_rowtail.py``): the same function as the mega-tail
(``kernels/mrla_megatail.py``) with the BN scale folded into the gate and λ
beforehand, as the JAX function folds them outside its kernel.  One kernel
(``csrc/mrla_rowtail.cu``) computes y and, given ``w1_next``, x1 with
tensor-core products inside the kernel.  ``out`` is relu(z + identity);
layouts as in ``kernels/mrla_epilogue.py``; ``w1_next`` is the next conv1's
(BN-folded) weight in the torch layout [C1, C, 1, 1] or [C1, C], ``b1_next``
its bias [C1].

Unlike the mega-tail it takes every (C, C1) of the resnet50 tail routes, up
to C = 2048 with C1 = 512: up to C = 1024 it runs the mega-tail's tiles,
above them a block of 48 pixels (32 for odd widths) computes x1 in chunks
of 128 (or 64) columns (``rowtail_tile``).  ``rowtail_covers`` states what
the kernel takes, as its C entry point decides.  The JAX kernel's row
pipeline, scratch ring and padding of C1 to 128 are TPU artifacts and have
no counterpart.

``mrla_rowtail`` launches the kernel for CUDA tensors (bf16) and runs the
plain version ``mrla_rowtail_reference`` only for CPU tensors; any other
input raises, and so does a (C, C1) the C entry point refuses
(cudaErrorInvalidValue, 1).  ``mrla_rowtail.counter`` counts calls and
launches, the launches also by (B, H, W, C, C1), with C1 = 0 for y alone.
"""

from __future__ import annotations

import torch

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import (
    check_cuda_args,
    check_tail_args,
    use_plain_version,
)
from mrla_tpu_torch.kernels.mrla_megatail import (
    MAX_SMEM_BYTES,
    _w1_matrix,
    megatail_tile,
    tail_x1_smem_bytes,
)
from mrla_tpu_torch.ops.common import depthwise_conv3x3


def rowtail_tile(c: int, c1: int) -> tuple[int, int, int]:
    """The x1 kernel's tile at (C, C1), as ``csrc/mrla_rowtail.cu`` picks
    it: (pixels a block, x1 columns a chunk, K chunk depth).  The
    mega-tail's up to C = 1024; above, (48, 128, 32) where C1 % 128 == 0
    and it fits (C up to 2112), else (32, 64, 32)."""
    if c <= 1024:
        return megatail_tile(c, c1)
    if c1 % 128 == 0 and tail_x1_smem_bytes(c, (48, 128, 32)) <= MAX_SMEM_BYTES:
        return 48, 128, 32
    return 32, 64, 32


def rowtail_smem_bytes(c: int, c1: int) -> int:
    """Shared memory of one block of the x1 kernel at (C, C1)."""
    return tail_x1_smem_bytes(c, rowtail_tile(c, c1))


def rowtail_covers(c: int, c1: int) -> bool:
    """True where the kernel takes a map of C channels and a next conv1 of
    C1 outputs (C1 = 0: y alone), as its C entry point decides: y alone
    takes C % 8 == 0; with x1, C % 64 == 0, C1 % 64 == 0 and the block's
    shared memory within 227 KB (C up to 3392 at any C1)."""
    if c <= 0 or c % 8 or c1 < 0:
        return False
    if c1 == 0:
        return True
    return (c % 64 == 0 and c1 % 64 == 0
            and rowtail_smem_bytes(c, c1) <= MAX_SMEM_BYTES)


def _fold(gate, lam, bn_scale):
    """gs = gate·bn_scale [B, C] and ls = λ·bn_scale [C], fp32."""
    sc = bn_scale.float()
    return ((gate.float() * sc).contiguous(),
            (lam.float() * sc).contiguous())


def mrla_rowtail_reference(out, identity, gate, wv, lam, bn_scale, bn_bias,
                           w1_next=None, b1_next=None):
    """Plain PyTorch version: fp32 taps, y summed in the kernel's order and
    rounded once; x1 from the rounded y."""
    c = out.shape[-1]
    gs, ls = _fold(gate, lam, bn_scale)
    o = out.float()
    v = depthwise_conv3x3(o, wv.float().t().reshape(c, 1, 3, 3))
    y = (o + v * gs[:, None, None, :] + ls * identity.float()
         + bn_bias.float()).to(out.dtype)
    if w1_next is None:
        return y
    w1 = _w1_matrix(w1_next, c).float()
    x1 = torch.relu(y.float() @ w1.t() + b1_next.float())
    return y, x1.to(out.dtype)


def mrla_rowtail(out, identity, gate, wv, lam, bn_scale, bn_bias,
                 w1_next=None, b1_next=None):
    """y [B, H, W, C], or (y, x1 [B, H, W, C1]) given ``w1_next``."""
    counter = mrla_rowtail.counter
    counter.calls += 1
    check_tail_args(out, identity, gate, wv, lam, bn_scale, bn_bias)
    b, h, w, c = out.shape
    if (w1_next is None) != (b1_next is None):
        raise ValueError("w1_next and b1_next go together")
    c1 = 0
    if w1_next is not None:
        w1_next = _w1_matrix(w1_next, c)
        c1 = w1_next.shape[0]
        if tuple(b1_next.shape) != (c1,):
            raise ValueError(f"b1_next must be ({c1},), got "
                             f"{tuple(b1_next.shape)}")
    if use_plain_version(out):
        return mrla_rowtail_reference(out, identity, gate, wv, lam, bn_scale,
                                      bn_bias, w1_next, b1_next)
    gs, ls = _fold(gate, lam, bn_scale)
    act = {"out": out, "identity": identity}
    vec = {"gs": gs, "wv": wv, "ls": ls, "bn_bias": bn_bias}
    if c1:
        b1_next = b1_next.float()
        act["w1_next"] = w1_next
        vec["b1_next"] = b1_next
    check_cuda_args(act, vec)
    y = torch.empty_like(out)
    x1 = (torch.empty((b, h, w, c1), dtype=out.dtype, device=out.device)
          if c1 else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(out.device):
        err = library().mrla_rowtail_bf16(
            out.data_ptr(), identity.data_ptr(), gs.data_ptr(),
            wv.data_ptr(), ls.data_ptr(), bn_bias.data_ptr(), ptr(w1_next),
            ptr(b1_next), y.data_ptr(), ptr(x1), b, h, w, c, c1,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"mrla_rowtail_bf16 (C={c}, C1={c1})")
    counter.launch((b, h, w, c, c1))
    return (y, x1) if c1 else y


mrla_rowtail.counter = LaunchCounter()
