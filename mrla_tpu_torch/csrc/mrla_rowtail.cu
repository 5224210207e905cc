// MRLA-light row tail, optionally fused with the next block's 1x1 conv, CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/mrla_rowtail.py (mrla_rowtail ->
// _rowtail_kernel).  With gs = gate * bn_scale [B, C] and ls = lam *
// bn_scale [C] folded in fp32 by the wrapper, as the JAX function folds them
// before its kernel:
//
//     y  = out + dwconv3x3(out) * gs + ls * id + bn_bias   (this order)
//     x1 = relu(bf16(y) @ W1 + b1)       (optional: the next block's conv1)
//
// The TPU kernel's row pipeline (a grid over H + 1 rows, a 2-row scratch
// ring, output blocks lagging one step) and its padding of C1 to 128 lanes
// are TPU artifacts and are not carried over: a block reads the 3x3
// neighbours from global memory, with bounds checks at rows 0 and H - 1
// and at the ends of any W.
//
// Bound on an H100: memory.  Read out and id, write y and x1: at stage 3 of
// resnet50 at 224 px, batch 128 ([128, 14, 14, 1024], C1 = 256) 167 MB,
// 0.050 ms at 3.35 TB/s, while the product, 13.2 GFLOP, takes 0.013 ms at
// the bf16 tensor-core peak.
//
// Design: tail_x1.cuh's kernel, the mega-tail's, with the row tail's y, for
// every (C, C1) the resnet50 tail routes give it, up to C = 2048 with C1 =
// 512, which the mega-tail's one-chunk tile cannot hold (a 64-pixel y tile
// and a whole C1 of W1 rows: 337 KB there).  Here a block holds 64 pixels
// for C <= 512 and 32 above, and computes x1 in chunks of 128 columns (64
// where C1 is no multiple of 128): 84 KB of shared memory at C = 1024, so
// two blocks share an SM (a 64-pixel tile, one a SM, took 1.8 to 1.9x as
// long there), and 147 KB at C = 2048.  Without W1 (C1 = 0) an elementwise
// kernel writes y.
#include "tail_x1.cuh"

namespace {

// Pixels per block and x1 columns per chunk; the wrapper's rowtail_covers
// (kernels/mrla_rowtail.py) states the same rules.
int tile_pixels(int C) { return C <= 512 ? 64 : 32; }
int chunk_cols(int C1) { return C1 % 128 == 0 ? 128 : 64; }

size_t smem_bytes(int C, int C1) {
  return tail_x1_smem_bytes(C, tile_pixels(C), chunk_cols(C1));
}

// y for channels c0..c0+7 of pixel p as bf16x8, summed in the JAX kernel's
// order.  a.gate holds gs [B, C] and a.lam ls [C]; a.scale is not read.
struct RowTailY {
  static __device__ __forceinline__ uint4 y8(const TailArgs& a, int64_t p,
                                            int c0) {
    float acc[8], o[8];
    tail_taps8<false>(a.out, nullptr, a.wv, a.H, a.W, a.C, p, c0, acc, o);
    float idv[8], gs[8], ls[8], bi[8];
    bf16x8_to_float(
        __ldg(reinterpret_cast<const uint4*>(a.id + p * a.C + c0)), idv);
    load_f8(a.gate + (p / ((int64_t)a.H * a.W)) * a.C + c0, gs);
    load_f8(a.lam + c0, ls);
    load_f8(a.bias + c0, bi);
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      y[i] = o[i] + acc[i] * gs[i] + ls[i] * idv[i] + bi[i];
    return pack_bf16x8(y);
  }
};

__global__ void __launch_bounds__(kX1Threads)
    rowtail_y_kernel(TailArgs a, __nv_bfloat16* __restrict__ y,
                     int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * kX1Threads + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = a.C / 8;
  const int64_t p = i / vecs;
  const int c0 = (int)(i % vecs) * 8;
  *reinterpret_cast<uint4*>(y + p * a.C + c0) = RowTailY::y8(a, p, c0);
}

}  // namespace

// out, id, y [B, H, W, C] bf16; gs [B, C], wv [9, C], ls, bias [C] fp32;
// with C1 > 0 also w1 [C1, C] bf16, b1 [C1] fp32 and x1 [B, H, W, C1] bf16.
// C1 == 0 (y only) takes C % 8 == 0; C1 > 0 takes C % 64 == 0, C1 % 64 ==
// 0 and smem_bytes(C, C1) <= kMaxSmem (so C up to 3328 at any C1).
// Anything else gives cudaErrorInvalidValue.
extern "C" int mrla_rowtail_bf16(const void* out, const void* id,
                                 const void* gs, const void* wv,
                                 const void* ls, const void* bias,
                                 const void* w1, const void* b1, void* y,
                                 void* x1, int B, int H, int W, int C, int C1,
                                 void* stream) {
  if (C <= 0 || C % 8 || C1 < 0) return (int)cudaErrorInvalidValue;
  if (C1 > 0 && (C % kX1KC || C1 % 64 || smem_bytes(C, C1) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  TailArgs a{static_cast<const __nv_bfloat16*>(out),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gs),
             static_cast<const float*>(wv),
             static_cast<const float*>(ls),
             nullptr,
             static_cast<const float*>(bias),
             H, W, C};
  const int64_t P = (int64_t)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C1 == 0) {
    const int64_t n_vec = P * (C / 8);
    const int64_t blocks = (n_vec + kX1Threads - 1) / kX1Threads;
    if (blocks > 0) {
      rowtail_y_kernel<<<(unsigned)blocks, kX1Threads, 0, s>>>(
          a, static_cast<__nv_bfloat16*>(y), n_vec);
    }
    return (int)cudaGetLastError();
  }
  // WM = BM / 16 warps along the pixels, NT = CN / ((8 / WM) x 8)
  const bool c128 = chunk_cols(C1) == 128;
  cudaError_t err;
  if (tile_pixels(C) == 64)
    err = c128 ? tail_x1_launch<RowTailY, 4, 8>(a, w1, b1, y, x1, P, C1, s)
               : tail_x1_launch<RowTailY, 4, 4>(a, w1, b1, y, x1, P, C1, s);
  else
    err = c128 ? tail_x1_launch<RowTailY, 2, 4>(a, w1, b1, y, x1, P, C1, s)
               : tail_x1_launch<RowTailY, 2, 2>(a, w1, b1, y, x1, P, C1, s);
  return (int)err;
}
