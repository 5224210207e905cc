// MRLA-light block tail fused with the next block's 1x1 conv, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/mrla_megatail.py
// (mrla_block_tail_fused_next -> _kernel).  In one pass over the map:
//
//     y  = out + (dwconv3x3(out) * gate + lam * id) * bn_scale + bn_bias
//     x1 = relu(bf16(y) @ W1 + b1)        (the next block's conv1, BN folded)
//
// and returns both, so y never makes a second trip through device memory
// to feed the next conv.
//
// Bound on an H100: memory.  Stage 1 of resnet50 at 224 px, batch 128
// (out, id, y [128, 56, 56, 256] bf16, x1 with C1 = 64) moves 668 MB, 0.199
// ms at 3.35 TB/s, while its product is 13.2 GFLOP, 0.013 ms at the bf16
// tensor-core peak: the product has to stay cheap enough to hide under the
// memory traffic, and must not send y back to memory.
//
// Design: tail_x1.cuh's kernel with the epilogue's y (mrla_tail_y8), 64
// pixels a block and the whole C1 in one chunk: eight warps, 4 along the
// pixels x 2 along C1.  W1 is streamed through shared memory in 64-deep K
// chunks: at C = 512, C1 = 256 it is 256 KB and does not fit a block's
// 227 KB.  Shared memory is 64 x (C + 8) + C1 x 72 bf16: 101 KB at C = 512,
// C1 = 256, so two blocks fit an SM.
#include "tail_x1.cuh"

namespace {

constexpr int kBM = 64;  // pixels per block

struct EpilogueY {
  static __device__ __forceinline__ uint4 y8(const TailArgs& a, int64_t p,
                                            int c0) {
    return mrla_tail_y8(a, p, c0);
  }
};

// The wrapper's megatail_covers (kernels/mrla_megatail.py) states the same.
size_t smem_bytes(int C, int C1) { return tail_x1_smem_bytes(C, kBM, C1); }

}  // namespace

// C % 64 == 0, C1 in {64, 128, 256} and smem_bytes(C, C1) <= kMaxSmem (so
// C up to 1472 at C1 = 256), else cudaErrorInvalidValue; the engine routes
// by the same three conditions (megatail_covers).
extern "C" int mrla_megatail_bf16(const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, const void* w1,
                                  const void* b1, void* y, void* x1, int B,
                                  int H, int W, int C, int C1, void* stream) {
  if (C <= 0 || C % kX1KC || smem_bytes(C, C1) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  TailArgs a{static_cast<const __nv_bfloat16*>(out),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate),
             static_cast<const float*>(wv),
             static_cast<const float*>(lam),
             static_cast<const float*>(scale),
             static_cast<const float*>(bias),
             H, W, C};
  const int64_t P = (int64_t)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4 warps along the pixels; NT = C1 / 16: the whole C1 in one chunk,
  // fixed at compile time
  switch (C1) {
    case 64:
      return (int)tail_x1_launch<EpilogueY, 4, 4, 64>(a, w1, b1, y, x1, P,
                                                      C1, s);
    case 128:
      return (int)tail_x1_launch<EpilogueY, 4, 8, 128>(a, w1, b1, y, x1, P,
                                                       C1, s);
    case 256:
      return (int)tail_x1_launch<EpilogueY, 4, 16, 256>(a, w1, b1, y, x1, P,
                                                        C1, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
