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
// Design: tail_x1.cuh's kernel, the mega-tail's, with the row tail's y,
// for every (C, C1) the resnet50 tail routes give it, up to C = 2048 with
// C1 = 512, which no 64-pixel tile can hold (a 64-pixel y tile alone is
// 256 KB there).  W1 comes through a 3-stage cp.async ring started before
// the y phase.  Up to C = 1024 the tiles are the mega-tail's (64 pixels,
// wgmma; at [128, 14, 14, 1024] 177 KB, one block an SM, 392 blocks, 3.0
// waves, W1 read from L2 205 MB where a 32-pixel tile read 411).
// Above, where C1 % 128 == 0 (C up to 2112): 48 pixels, three m16 tiles a
// warp on mma.sync + ldmatrix, x1 in chunks of 128 columns, 32-deep K
// chunks (three stages: 24 KB), 216 KB at C = 2048, one block an SM, so
// that 131 blocks cover [128, 7, 7, 2048] in 0.99 waves (32-pixel tiles:
// 196 blocks, 1.48 waves) and W1 is read from L2 275 MB, not 411; the y
// phase two pixels at a time with the 3x3 weights in registers.  Any other
// (C, C1) up to C = 3392: 32 pixels x 64 columns, 32-deep K chunks, y by
// 8-channel vectors.  No thread-block cluster (see mrla_megatail.cu).
// Without W1 (C1 = 0) an elementwise kernel writes y.
#include "tail_x1.cuh"

namespace {

// The tiles above C = 1024 (see the note at the top).
using Tile48x128 = X1Tile<1, 3, 2, 32, 1, 2, 0>;
using Tile32x64k32 = X1Tile<2, 1, 2, 32, 1, 0, 0>;

// f(Tile{}) for the tile of (C, C1), C1 % 64 == 0; the wrapper's
// rowtail_tile (kernels/mrla_rowtail.py) states the same rule.
template <class F>
cudaError_t with_tile(int C, int C1, F&& f) {
  if (C <= 1024) return tail_x1_with_tile(C, C1, f);
  if (C1 % 128 == 0 && Tile48x128::smem_bytes(C) <= kMaxSmem)
    return f(Tile48x128{});
  return f(Tile32x64k32{});
}

// With x1: C % 64 == 0, C1 % 64 == 0 and the tile's shared memory within a
// block's (C up to 3392): rowtail_covers in the wrapper.
bool covers(int C, int C1) {
  if (C <= 0 || C % 64 || C1 <= 0 || C1 % 64) return false;
  size_t smem = 0;
  with_tile(C, C1, [&](auto t) {
    smem = decltype(t)::smem_bytes(C);
    return cudaSuccess;
  });
  return smem <= kMaxSmem;
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
      y[i] = combine(o[i], acc[i], gs[i], idv[i], ls[i], 0.f, bi[i]);
    return pack_bf16x8(y);
  }
  // the constants of channels c0..c0+7: ls, (none), bias
  static __device__ __forceinline__ void consts(const TailArgs& a, int c0,
                                                float ls[8], float unused[8],
                                                float bi[8]) {
    load_f8(a.lam + c0, ls);
    load_f8(a.bias + c0, bi);
#pragma unroll
    for (int i = 0; i < 8; ++i) unused[i] = 0.f;
  }
  static __device__ __forceinline__ float combine(float o, float acc,
                                                  float gs, float id,
                                                  float ls, float, float bi) {
    return o + acc * gs + ls * id + bi;
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
// C1 == 0 (y only) takes C % 8 == 0; C1 > 0 takes what covers() does (C
// up to 3392 at any C1 % 64 == 0).  Anything else gives
// cudaErrorInvalidValue.
extern "C" int mrla_rowtail_bf16(const void* out, const void* id,
                                 const void* gs, const void* wv,
                                 const void* ls, const void* bias,
                                 const void* w1, const void* b1, void* y,
                                 void* x1, int B, int H, int W, int C, int C1,
                                 void* stream) {
  if (C <= 0 || C % 8 || C1 < 0 || (C1 > 0 && !covers(C, C1)))
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
  return (int)with_tile(C, C1, [&](auto t) {
    return tail_x1_launch<RowTailY, decltype(t)>(a, w1, b1, y, x1, P, C1, s);
  });
}

// The launch's tile at (C, C1 > 0) and the blocks an SM holds
// (tail_x1_describe's six numbers).
extern "C" int mrla_rowtail_describe(int C, int C1, int* out) {
  if (!covers(C, C1)) return (int)cudaErrorInvalidValue;
  return (int)with_tile(C, C1, [&](auto t) {
    return tail_x1_describe<RowTailY, decltype(t)>(C, out);
  });
}
