"""The block tail on the [H, W, B, C] view, and a copy through that view.

The JAX package has two TPU kernels for one function, the MRLA-light block
tail from the pre-residual map z:

    y = x + (dwconv3x3(x)·gate + λ·id)·bn_scale + bn_bias,  x = relu(z + id)

``mrla_block_tail_pallas`` reads the [B, H, W, C] map, and
``mrla_block_tail_hwbc`` (``mrla_tpu/kernels/mrla_epilogue_hwbc.py``) reads
its [H, W, B, C] view, because that view is XLA's native activation layout
on the TPU, where reading the logical layout forces a copy per block.  Here
activations are NHWC and the [H, W, B, C] view is only a way of walking the
same map, so ``mrla_block_tail_hwbc`` launches the same CUDA kernel as
``mrla_block_tail`` (``csrc/mrla_block_tail.cu``), under its own counter, and
takes any B: the JAX version's batch tile, which needs B % min(B, 64) == 0,
is a TPU artifact.

``hwbc_copy`` is the counterpart of ``scripts/exp_boundary.py:hwbc_copy``, a
copy of a [B, H, W, C] map through its [H, W, B, C] view that measured what
a custom call costs in-model on the TPU.  It returns a new tensor equal to
``x`` for any B (the JAX kernel's grid has B // 8 batch tiles and leaves
the images past them out), copied by ``csrc/hwbc_copy.cu`` with 16-byte
accesses, never an alias of ``x``.

Both wrappers run their plain versions only for CPU tensors, launch their
kernels for CUDA tensors (bf16, contiguous NHWC, C % 8 == 0: the C entry
points return cudaErrorInvalidValue (1) otherwise, and the wrappers raise)
and raise for any other device.  Their counters count calls and launches,
the launches also by (B, H, W, C).
"""

from __future__ import annotations

import torch

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import (
    block_tail_gate,
    check_cuda_args,
    run_block_tail,
    use_plain_version,
)


def mrla_block_tail_hwbc(z, identity, wq, wk, wv, lam, bn_scale, bn_bias,
                         heads: int) -> torch.Tensor:
    """The block tail from z (the JAX ``mrla_block_tail_hwbc``): gate in
    PyTorch, then the block-tail kernel; y [B, H, W, C] like ``z``."""
    counter = mrla_block_tail_hwbc.counter
    counter.calls += 1
    gate = block_tail_gate(z, identity, wq, wk, heads)
    return run_block_tail(counter, z, identity, gate, wv, lam, bn_scale,
                          bn_bias)


mrla_block_tail_hwbc.counter = LaunchCounter()


def hwbc_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: an elementwise copy into a new tensor."""
    return torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)


def hwbc_copy(x: torch.Tensor) -> torch.Tensor:
    """A new [B, H, W, C] tensor equal to ``x``."""
    counter = hwbc_copy.counter
    counter.calls += 1
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if use_plain_version(x):
        return hwbc_copy_reference(x)
    check_cuda_args({"x": x}, {})
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().hwbc_copy_bf16(
            x.data_ptr(), y.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    check(err, f"hwbc_copy_bf16 (C={c})")
    counter.launch((b, h, w, c))
    return y


hwbc_copy.counter = LaunchCounter()
