// MRLA-light block tail from the pre-residual map, CUDA C++ for sm_90a.
//
// Replaces two TPU kernels, which compute one function:
//   mrla_tpu/kernels/mrla_epilogue.py (mrla_block_tail_pallas ->
//   _mega_kernel), on the [B, H, W, C] map, and
//   mrla_tpu/kernels/mrla_epilogue_hwbc.py (mrla_block_tail_hwbc ->
//   _kernel), on its [H, W, B, C] view:
//
//     x = relu(z + id)                              (fp32, never stored)
//     y = x + (dwconv3x3(x) * gate + lam * id) * bn_scale + bn_bias
//
// with the [B, C] gate computed beforehand in PyTorch from relu(z + id)
// rounded once to bf16, as the JAX functions do.  The [H, W, B, C] view is
// the TPU's native activation layout; here activations are NHWC, so the two
// are one kernel under two wrappers.
//
// Bound on an H100: memory.  Per element it reads z and id (2 x 2 bytes)
// and writes y (2 bytes): at stage 1 of resnet50 at 224 px, batch 128
// ([128, 56, 56, 256]) that is 617 MB, 0.184 ms at 3.35 TB/s.  Forming x in
// the kernel saves the write and re-read of `out` that the epilogue needs.
//
// Design: the epilogue kernel's (mrla_epilogue.cu): one thread per 8
// channels of one pixel, 16-byte accesses along C, the 8 neighbours of the
// 3x3 window read again from L1/L2, here for z and id both.  No shared
// memory, no synchronisation.
#include "mrla_tail.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    mrla_block_tail_kernel(TailArgs a, __nv_bfloat16* __restrict__ y,
                           int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = a.C / 8;
  const int64_t p = i / vecs;
  const int c0 = (int)(i % vecs) * 8;
  *reinterpret_cast<uint4*>(y + p * a.C + c0) = mrla_block_tail_y8(a, p, c0);
}

}  // namespace

// z, id, y [B, H, W, C] bf16; gate [B, C], wv [9, C], lam, scale, bias [C]
// fp32.  C % 8 == 0, else cudaErrorInvalidValue.
extern "C" int mrla_block_tail_bf16(const void* z, const void* id,
                                    const void* gate, const void* wv,
                                    const void* lam, const void* scale,
                                    const void* bias, void* y, int B, int H,
                                    int W, int C, void* stream) {
  if (C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  TailArgs a{static_cast<const __nv_bfloat16*>(z),
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
    mrla_block_tail_kernel<<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<__nv_bfloat16*>(y), n_vec);
  }
  return (int)cudaGetLastError();
}
