// Copy of a bf16 activation map into a new buffer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel scripts/exp_boundary.py (hwbc_copy ->
// _copy_kernel), which copies a [B, H, W, C] map through its [H, W, B, C]
// view to measure what a custom call costs in-model.  In NHWC the view is
// the same bytes, so the copy is a straight one; unlike the TPU kernel,
// whose grid has B / 8 batch tiles, it copies every image for any B.
//
// Bound on an H100: memory, 4 bytes per element (read 2, write 2): 0.123 ms
// at 3.35 TB/s for stage 1 of resnet50 at 224 px, batch 128
// ([128, 56, 56, 256]).
//
// Design: 16-byte loads and stores, four per thread in flight, threads of a
// warp on neighbouring addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    hwbc_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     int64_t n_vec) {
  const int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + (int64_t)u * kThreads;
    if (i < n_vec) v[u] = __ldg(x + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + (int64_t)u * kThreads;
    if (i < n_vec) y[i] = v[u];
  }
}

}  // namespace

// x, y [B, H, W, C] bf16, 16-byte aligned, not overlapping.  C % 8 == 0,
// else cudaErrorInvalidValue.
extern "C" int hwbc_copy_bf16(const void* x, void* y, int B, int H, int W,
                              int C, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const int64_t n_vec = (int64_t)B * H * W * (C / 8);
  const int64_t per_block = (int64_t)kThreads * kUnroll;
  const int64_t blocks = (n_vec + per_block - 1) / per_block;
  if (blocks > 0) {
    hwbc_copy_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec);
  }
  return (int)cudaGetLastError();
}
