"""Bytes and operations of the port's MRLA kernels as functions of the
function's shapes, the same whatever implements it: each input byte read
once, each output byte written once, and the operations the function
needs (counts of the kernel table, PERF.md; activations bf16, vectors
fp32).  Each returns ``(bytes, bf16 tensor FLOPs, fp32 element-wise
FLOPs)``; ``peaks.bound_s(*work)`` is the least time of one launch."""

# per element: 9 taps (a multiply-add is 2), the gate, lambda * identity,
# BN's affine and the residual
TAIL_FP32_OPS = 24
# per element: two LayerNorms (8 each), the grid mean, 9 taps, the exact
# GELU (about 23), the gate, lambda * normo and the residual
DEIT_TAIL_FP32_OPS = 60


def epilogue(b: int, h: int, w: int, c: int) -> tuple:
    """y = out + (dwconv3x3(out) * gate + lambda * id) * scale + bias:
    out and id read, y written (bf16), the gate [B, C] and 12 fp32
    vectors of C (9 taps, lambda, scale, bias) read."""
    n = b * h * w * c
    return 3 * n * 2 + b * c * 4 + 12 * c * 4, 0.0, TAIL_FP32_OPS * n


def megatail(b: int, h: int, w: int, c: int, c1: int) -> tuple:
    """The epilogue and the next block's 1 x 1 conv of y: also W1 [C1, C]
    (bf16) and b1 [C1] (fp32) read and x1 [B, H, W, C1] written."""
    p = b * h * w
    n = p * c
    nbytes = (3 * n * 2 + p * c1 * 2 + c * c1 * 2 + c1 * 4 + b * c * 4
              + 12 * c * 4)
    return nbytes, 2.0 * p * c * c1, TAIL_FP32_OPS * n


def token_tail(b: int, n: int, c: int, ktap: int) -> tuple:
    """x + the MRLA-light token module on x and ot [B, N, C]: x and ot
    read, the result written (bf16), the 14 packed fp32 vectors of C and
    the 2 x k taps read."""
    elems = b * n * c
    return (3 * elems * 2 + 14 * c * 4 + 2 * ktap * 4, 0.0,
            DEIT_TAIL_FP32_OPS * elems)
