"""MRLA-light block tail fused with the next block's 1x1 conv.

    y  = out + (dwconv3x3(out)·gate + λ·id)·bn_scale + bn_bias
    x1 = relu(bf16(y) @ W1 + b1)                 # next block's conv1

One kernel (``csrc/mrla_megatail.cu`` on ``csrc/tail_x1.cuh``) computes
both in one pass over the map and returns (y, x1), the counterpart of the
JAX package's ``mrla_block_tail_fused_next``: 64 pixels a block, W1 through
a ring of K chunks in shared memory, the product on wgmma
(``megatail_tile`` states the tile).  ``out`` is relu(z + identity) and the
gate comes from ``mrla_light_gate``; layouts as in
``kernels/mrla_epilogue.py``.
``w1_next`` is the next conv1's (BN-folded) weight in the torch layout
[C1, C, 1, 1] or [C1, C]; ``b1_next`` its bias [C1].

``mrla_block_tail_fused_next`` launches the kernel for CUDA tensors (bf16)
and runs the plain version only for CPU tensors; any other input raises.
The kernel takes C % 64 == 0, C1 in {64, 128, 256} and a tile that fits a
block's shared memory (``megatail_covers`` states all three; the engine
routes by it); its C entry point makes the same three checks, returns
cudaErrorInvalidValue (1) for anything else, and the wrapper raises.
``mrla_block_tail_fused_next.counter`` counts calls and launches, the
launches also by (B, H, W, C, C1).
"""

from __future__ import annotations

import torch

from mrla_tpu_torch.kernels._build import LaunchCounter, check, library
from mrla_tpu_torch.kernels.mrla_epilogue import (
    check_cuda_args,
    check_tail_args,
    fused_epilogue_reference,
    use_plain_version,
)

MEGATAIL_C1 = (64, 128, 256)
MAX_SMEM_BYTES = 232448  # a block's dynamic shared memory on sm_90
RING_STAGES = 3  # W1 chunks in the kernels' ring (tail_x1.cuh's kX1Stages)


def tail_x1_smem_bytes(c: int, tile: tuple[int, int, int]) -> int:
    """Shared memory of one block of ``csrc/tail_x1.cuh``'s kernel with
    ``tile`` = (pixels, x1 columns a chunk, K chunk depth): the bf16 y tile
    [pixels, C], a ring of RING_STAGES W1 chunks [columns, depth] and, for
    the 64-pixel tiles, whose product runs on wgmma, 1 KB to align both to
    1024 bytes."""
    bm, cn, kc = tile
    return 2 * (bm * c + RING_STAGES * cn * kc) + (1024 if bm == 64 else 0)


def megatail_tile(c: int, c1: int) -> tuple[int, int, int]:
    """The mega-tail's tile at (C, C1), as ``csrc/tail_x1.cuh``'s
    ``tail_x1_with_tile`` picks it: (pixels a block, x1 columns a chunk, K
    chunk depth) = (64, 128, 64) above C = 256 where C1 % 128 == 0, else
    (64, 64, 64)."""
    return 64, (128 if c > 256 and c1 % 128 == 0 else 64), 64


def megatail_smem_bytes(c: int, c1: int) -> int:
    """Shared memory of one block of the mega-tail at (C, C1)."""
    return tail_x1_smem_bytes(c, megatail_tile(c, c1))


def megatail_covers(c: int, c1: int) -> bool:
    """True where the kernel takes a map of C channels and a next conv1 of
    C1 outputs, as its C entry point decides: C % 64 == 0, C1 in
    {64, 128, 256} and the block's shared memory within 227 KB (so C up to
    1408 at C1 = 128 or 256, 1600 at C1 = 64; not stage 4's 2048)."""
    return (c > 0 and c % 64 == 0 and c1 in MEGATAIL_C1
            and megatail_smem_bytes(c, c1) <= MAX_SMEM_BYTES)


def _w1_matrix(w1_next: torch.Tensor, c: int) -> torch.Tensor:
    c1 = w1_next.shape[0] if w1_next.dim() else 0
    if tuple(w1_next.shape) not in ((c1, c, 1, 1), (c1, c)):
        raise ValueError(
            f"w1_next must be [C1, {c}, 1, 1] or [C1, {c}], got "
            f"{tuple(w1_next.shape)}"
        )
    return w1_next.reshape(w1_next.shape[0], c)


def mrla_block_tail_fused_next_reference(
    out, identity, gate, wv, lam, bn_scale, bn_bias, w1_next, b1_next,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the epilogue, then the product on the y that
    was rounded to the output dtype."""
    y = fused_epilogue_reference(out, identity, gate, wv, lam, bn_scale,
                                 bn_bias)
    w1 = _w1_matrix(w1_next, out.shape[-1]).float()
    x1 = torch.relu(y.float() @ w1.t() + b1_next.float())
    return y, x1.to(out.dtype)


def mrla_block_tail_fused_next(
    out, identity, gate, wv, lam, bn_scale, bn_bias, w1_next, b1_next,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, H, W, C], x1 [B, H, W, C1]) in one pass."""
    counter = mrla_block_tail_fused_next.counter
    counter.calls += 1
    check_tail_args(out, identity, gate, wv, lam, bn_scale, bn_bias)
    b, h, w, c = out.shape
    w1 = _w1_matrix(w1_next, c)
    c1 = w1.shape[0]
    if tuple(b1_next.shape) != (c1,):
        raise ValueError(f"b1_next must be ({c1},), got {tuple(b1_next.shape)}")
    if use_plain_version(out):
        return mrla_block_tail_fused_next_reference(
            out, identity, gate, wv, lam, bn_scale, bn_bias, w1, b1_next)
    b1 = b1_next.float()
    check_cuda_args(
        {"out": out, "identity": identity, "w1_next": w1},
        {"gate": gate, "wv": wv, "lam": lam, "bn_scale": bn_scale,
         "bn_bias": bn_bias, "b1_next": b1},
    )
    y = torch.empty_like(out)
    x1 = torch.empty((b, h, w, c1), dtype=out.dtype, device=out.device)
    with torch.cuda.device(out.device):
        err = library().mrla_megatail_bf16(
            out.data_ptr(), identity.data_ptr(), gate.data_ptr(),
            wv.data_ptr(), lam.data_ptr(), bn_scale.data_ptr(),
            bn_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(),
            x1.data_ptr(), b, h, w, c, c1,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"mrla_megatail_bf16 (C={c}, C1={c1})")
    counter.launch((b, h, w, c, c1))
    return y, x1


mrla_block_tail_fused_next.counter = LaunchCounter()
