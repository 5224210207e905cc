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
// Design: tail_window.cuh's sliding 3x3 window, the block tail's kernel
// with a column of FromOut pieces (out of rows h - 1, h, h + 1 and the
// centre row's id: 4 copies of 16 bytes a pixel, where a thread per 8
// channels of one pixel issued 9 loads of out, 18 of the weights and 5 of
// the constants and divided out (b, h, w)).  y is bit for bit mrla_tail_y8's
// (the mega-tail's y phase): the same taps in the same order and the same
// finish.
#include "tail_window.cuh"

namespace {

// The launch, chosen by measurement (tune_epilogue.py): 64 threads a
// block, the window as fp32, a ring of 4 columns (16 KB of shared memory)
// on rows under 28 pixels and of 8 (32 KB) from 28 on; a row is one
// segment up to kMaxSegment pixels and is cut into equal segments beyond.
constexpr int kThreads = 64;
constexpr int kMaxSegment = 64;
constexpr bool kPackedWindow = false;

template <class F>
cudaError_t with_ring(int W, F&& f) {
  if (W >= 28)
    return f(tail_window_kernel<FromOut, kPackedWindow, kThreads, 8>,
             ring_bytes<FromOut>(kThreads, 8), 8);
  return f(tail_window_kernel<FromOut, kPackedWindow, kThreads, 4>,
           ring_bytes<FromOut>(kThreads, 4), 4);
}

}  // namespace

// out, id, y [B, H, W, C] bf16; gate [B, C], wv [9, C], lam, scale, bias
// [C] fp32.  C % 8 == 0, else cudaErrorInvalidValue.
extern "C" int mrla_epilogue_bf16(const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, void* y, int B, int H,
                                  int W, int C, void* stream) {
  if (C < 0 || C % 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const TailArgs a = tail_args(out, id, gate, wv, lam, scale, bias, H, W, C);
  return (int)with_ring(W, [&](auto kernel, size_t smem, int) {
    return launch_window(kernel, kThreads, smem, kMaxSegment, a, y, B,
                         static_cast<cudaStream_t>(stream));
  });
}

// What the launch at [B, H, W, C] is: out[0] the segment length (pixels a
// thread walks), out[1] threads a block, out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] blocks, out[4]
// columns in a thread's ring, out[5] 1 if the window holds packed bf16,
// 0 if fp32.
extern "C" int mrla_epilogue_describe(int B, int H, int W, int C, int* out) {
  if (C <= 0 || C % 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  out[5] = kPackedWindow ? 1 : 0;
  return (int)with_ring(W, [&](auto kernel, size_t smem, int stages) {
    return describe_window(kernel, kThreads, smem, stages, kMaxSegment, B, H,
                           W, C, out);
  });
}
