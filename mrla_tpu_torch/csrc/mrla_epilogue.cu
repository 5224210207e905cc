// MRLA-light block epilogue, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/mrla_epilogue.py
// (mrla_light_epilogue_pallas -> _fused_call -> _epilogue_kernel):
//
//     y = out + (dwconv3x3(out) * gate + lam * id) * bn_scale + bn_bias
//
// with the [B, C] gate computed beforehand in PyTorch (mrla_light_gate).
//
// Bound on an H100: memory.  Per element it reads out and id (2 x 2 bytes)
// and writes y (2 bytes) for about 24 fp32 operations, some 4 operations a
// byte, far below the card's balance point; at stage 3 of resnet50 at
// 224 px, batch 128 ([128, 14, 14, 1024]) that is 154 MB, 0.046 ms at
// 3.35 TB/s.
//
// Design: one thread per 8 channels of one pixel, threads running along C,
// so a warp reads 512 contiguous bytes of out, id and y with 16-byte
// accesses.  The 8 neighbour reads of the 3x3 window hit L1/L2 (the rows
// above and below are read by neighbouring blocks at about the same time),
// so device memory sees out, id and y once each.  There is no shared memory
// and no synchronisation: nothing limits occupancy but registers.
#include "mrla_tail.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    mrla_epilogue_kernel(TailArgs a, __nv_bfloat16* __restrict__ y,
                         int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = a.C / 8;
  const int64_t p = i / vecs;
  const int c0 = (int)(i % vecs) * 8;
  *reinterpret_cast<uint4*>(y + p * a.C + c0) = mrla_tail_y8(a, p, c0);
}

}  // namespace

// C % 8 == 0, else cudaErrorInvalidValue.
extern "C" int mrla_epilogue_bf16(const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, void* y, int B, int H,
                                  int W, int C, void* stream) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  TailArgs a{static_cast<const __nv_bfloat16*>(out),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate),
             static_cast<const float*>(wv),
             static_cast<const float*>(lam),
             static_cast<const float*>(scale),
             static_cast<const float*>(bias),
             H, W, C};
  const int64_t n_vec = (int64_t)B * H * W * (C / 8);
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0) {
    mrla_epilogue_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<__nv_bfloat16*>(y), n_vec);
  }
  return (int)cudaGetLastError();
}
