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
// Design: tail_x1.cuh's kernel with the epilogue's y: 64 pixels a block,
// W1's 64-deep K chunks through a 3-stage cp.async ring started before the
// y phase, the product on wgmma.  Two tiles (tail_x1_with_tile):
//   * C <= 256, or C1 % 128 != 0: x1 in chunks of 64 columns; shared memory
//     128 C + 25 KB (57 KB at C = 256), 128 registers a thread, two blocks
//     an SM; the y phase one pixel at a time.  [128, 56, 56, 256]: 6,272
//     blocks, 23.8 waves;
//   * above C = 256 where C1 % 128 == 0: chunks of 128 columns; 128 C +
//     49 KB (113 KB at C = 512, 177 KB at C = 1024), about 240 registers,
//     one block an SM, the y phase two pixels at a time with the 3x3
//     weights in registers.  [128, 28, 28, 512]: 1,568 blocks, 11.9 waves;
//     the detection trunk's [8, 50, 84, 1024]: 525 blocks, 4.0 waves.
// No thread-block cluster: every block reads W1 from L2 (205 MB at
// [128, 28, 28, 512], C1 = 128), which the 64-pixel tile halves against a
// 32-pixel one; sharing chunks by TMA multicast is left open (PERF.md §7).
#include "tail_x1.cuh"

namespace {

// y = out + (dwconv3x3(out) * gate + lam * id) * scale + bias: y8 for 8
// channels of a pixel, or consts + combine for one value of them.
struct EpilogueY {
  static __device__ __forceinline__ uint4 y8(const TailArgs& a, int64_t p,
                                            int c0) {
    return mrla_tail_y8(a, p, c0);
  }
  // the constants of channels c0..c0+7: lam, scale, bias
  static __device__ __forceinline__ void consts(const TailArgs& a, int c0,
                                                float lam[8], float sc[8],
                                                float bi[8]) {
    load_f8(a.lam + c0, lam);
    load_f8(a.scale + c0, sc);
    load_f8(a.bias + c0, bi);
  }
  static __device__ __forceinline__ float combine(float o, float acc,
                                                  float g, float id,
                                                  float lam, float sc,
                                                  float bi) {
    return mrla_tail_combine(o, acc, g, lam, id, sc, bi);
  }
};

// f(Tile{}) for the tile of (C, C1); the wrapper's megatail_tile
// (kernels/mrla_megatail.py) states the same rule.
template <class F>
cudaError_t with_tile(int C, int C1, F&& f) {
  return tail_x1_with_tile(C, C1, f);
}

// C % 64 == 0, C1 in {64, 128, 256} and the tile's shared memory within a
// block's: megatail_covers in the wrapper.
bool covers(int C, int C1) {
  if (C <= 0 || C % 64 || (C1 != 64 && C1 != 128 && C1 != 256))
    return false;
  size_t smem = 0;
  with_tile(C, C1, [&](auto t) {
    smem = decltype(t)::smem_bytes(C);
    return cudaSuccess;
  });
  return smem <= kMaxSmem;
}

}  // namespace

// Anything megatail_covers refuses gives cudaErrorInvalidValue.
extern "C" int mrla_megatail_bf16(const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, const void* w1,
                                  const void* b1, void* y, void* x1, int B,
                                  int H, int W, int C, int C1, void* stream) {
  if (!covers(C, C1)) return (int)cudaErrorInvalidValue;
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
  return (int)with_tile(C, C1, [&](auto t) {
    return tail_x1_launch<EpilogueY, decltype(t)>(a, w1, b1, y, x1, P, C1, s);
  });
}

// The launch's tile at (C, C1) and the blocks an SM holds
// (tail_x1_describe's six numbers).
extern "C" int mrla_megatail_describe(int C, int C1, int* out) {
  if (!covers(C, C1)) return (int)cudaErrorInvalidValue;
  return (int)with_tile(C, C1, [&](auto t) {
    return tail_x1_describe<EpilogueY, decltype(t)>(C, out);
  });
}
