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
// ([128, 56, 56, 256]).  x.clone() (a CUDA device-to-device memcpy)
// reaches 2.97 TB/s there; an earlier design, 4 vectors a thread in
// 256-thread blocks, stayed 0.6% behind it.
//
// Design: one 16-byte vector a thread (a read-only load, a plain store),
// 1024-thread blocks in one launch that covers the map: the block
// scheduler hands out consecutive blocks in order, so the open DRAM pages
// follow the map.  It was chosen over a persistent grid-stride copy (8
// blocks of 256 threads an SM, 8 loads in flight a thread) and a TMA
// cp.async.bulk ring (4 stages of 16 KB a block, one issuing thread, an
// mbarrier a stage), both slower at [128, 56, 56, 256] (PERF.md section
// 6); evict-first hints (__ldcs / __stcs), smaller blocks and more vectors
// a thread gave it no edge.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    hwbc_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vec) y[i] = __ldg(x + i);
}

}  // namespace

// x, y [B, H, W, C] bf16, 16-byte aligned, not overlapping.  C % 8 == 0,
// else cudaErrorInvalidValue.
extern "C" int hwbc_copy_bf16(const void* x, void* y, int B, int H, int W,
                              int C, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const int64_t n_vec = (int64_t)B * H * W * (C / 8);
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0) {
    hwbc_copy_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec);
  }
  return (int)cudaGetLastError();
}
