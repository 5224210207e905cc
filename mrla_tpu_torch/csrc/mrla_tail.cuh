// The MRLA-light block tail, shared by the epilogue, mega-tail, block-tail,
// row-tail and stage-4 kernels; mrla_tail_y8 computes it for 8 channels of
// one bf16 pixel (mrla_block_tail_y8 from z, with out = relu(z + id)):
//
//     y = out + (dwconv3x3(out) * gate + lam * id) * scale + bias
//
// Activations are NHWC bf16, C a multiple of 8, pointers 16-byte aligned, so
// one uint4 holds the 8 channels c0..c0+7 of a pixel.  The 3x3 taps read
// the neighbours straight from global memory (L1/L2 serve the re-reads) and
// are zero outside the pixel's own image: rows above and below a row of
// image b never come from image b +- 1.  Taps, gate and the sum are fp32;
// y is rounded to bf16 once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct TailArgs {
  const __nv_bfloat16* out;  // [B, H, W, C]
  const __nv_bfloat16* id;   // [B, H, W, C]
  const float* gate;         // [B, C]
  const float* wv;           // [9, C], tap (dh + 1) * 3 + (dw + 1)
  const float* lam;          // [C]
  const float* scale;        // [C]
  const float* bias;         // [C]
  int H, W, C;
};

__device__ __forceinline__ void bf16x8_to_float(const uint4 v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void load_f8(const float* p, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The arithmetic every MRLA tail ends in, for one value: `acc` is the
// depthwise 3x3 sum of `o`'s neighbourhood, `g` the channel's gate.  Shared
// by the bf16 tails here and the fp32 tail of the stage-4 kernel.
__device__ __forceinline__ float mrla_tail_combine(float o, float acc, float g,
                                                   float lam, float id,
                                                   float sc, float bi) {
  return o + (acc * g + lam * id) * sc + bi;
}

// The depthwise 3x3 sum `acc` of x around pixel p = (b * H + h) * W + w and
// x at p itself (`o`), for channels c0..c0+7.  x is `src`, or with
// kResidual relu(src + id): the block's pre-residual map z and its identity
// are read at every tap and summed in fp32, and that x is never rounded.
template <bool kResidual>
__device__ __forceinline__ void tail_taps8(const __nv_bfloat16* src,
                                           const __nv_bfloat16* id,
                                           const float* wv, int H, int W,
                                           int C, int64_t p, int c0,
                                           float acc[8], float o[8]) {
  const int w = (int)(p % W);
  const int64_t bh = p / W;
  const int h = (int)(bh % H);
  const int64_t img = (bh / H) * H;  // first row of this image

  float x[8], t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = o[i] = 0.f;
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh) {
    const int hh = h + dh;
    if (hh < 0 || hh >= H) continue;
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw) {
      const int ww = w + dw;
      if (ww < 0 || ww >= W) continue;
      const int64_t q = ((img + hh) * W + ww) * C + c0;
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(src + q)), x);
      if constexpr (kResidual) {
        float r[8];
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(id + q)), r);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = fmaxf(x[i] + r[i], 0.f);
      }
      load_f8(wv + ((dh + 1) * 3 + (dw + 1)) * C + c0, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(x[i], t[i], acc[i]);
      if (dh == 0 && dw == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = x[i];
      }
    }
  }
}

__device__ __forceinline__ uint4 pack_bf16x8(const float y[8]) {
  return make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                    pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
}

// y from the taps of pixel p, channels c0..c0+7, packed as bf16x8.
__device__ __forceinline__ uint4 mrla_tail_finish8(const TailArgs& a,
                                                   int64_t p, int c0,
                                                   const float acc[8],
                                                   const float o[8]) {
  const int64_t self = p * a.C + c0;
  float idv[8], g[8], lam[8], sc[8], bi[8];
  bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(a.id + self)), idv);
  load_f8(a.gate + (p / ((int64_t)a.H * a.W)) * a.C + c0, g);
  load_f8(a.lam + c0, lam);
  load_f8(a.scale + c0, sc);
  load_f8(a.bias + c0, bi);
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    y[i] = mrla_tail_combine(o[i], acc[i], g[i], lam[i], idv[i], sc[i], bi[i]);
  return pack_bf16x8(y);
}

// y for channels c0..c0+7 of pixel p, packed as bf16x8.
__device__ __forceinline__ uint4 mrla_tail_y8(const TailArgs& a, int64_t p,
                                              int c0) {
  float acc[8], o[8];
  tail_taps8<false>(a.out, nullptr, a.wv, a.H, a.W, a.C, p, c0, acc, o);
  return mrla_tail_finish8(a, p, c0, acc, o);
}

// The block tail from z: the same y with out = relu(z + id) formed in fp32
// at every tap (a.out holds z), unrounded in the taps and the residual.
__device__ __forceinline__ uint4 mrla_block_tail_y8(const TailArgs& a,
                                                    int64_t p, int c0) {
  float acc[8], o[8];
  tail_taps8<true>(a.out, a.id, a.wv, a.H, a.W, a.C, p, c0, acc, o);
  return mrla_tail_finish8(a, p, c0, acc, o);
}
