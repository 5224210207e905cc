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
// Design: tail_window.cuh's sliding 3x3 window (FromZ: each window column
// formed once from one load of z and id, kept as fp32); y is bit for bit
// mrla_block_tail_y8's.
#include "tail_window.cuh"

namespace {

// The launch, chosen by measurement (tune_block_tail.py): 64 threads a
// block; rings of 8 columns (48 KB of shared memory) on rows of 28 pixels
// or more, of 4 on shorter rows, whose few columns a deeper ring would
// only fill at the start.  A row is one segment up to kMaxSegment pixels
// and is cut into equal segments beyond.
constexpr int kThreads = 64;
constexpr int kMaxSegment = 64;

template <class F>
cudaError_t with_ring(int W, F&& f) {
  if (W >= 28)
    return f(tail_window_kernel<FromZ, false, kThreads, 8>,
             ring_bytes<FromZ>(kThreads, 8), 8);
  return f(tail_window_kernel<FromZ, false, kThreads, 4>,
           ring_bytes<FromZ>(kThreads, 4), 4);
}

}  // namespace

// z, id, y [B, H, W, C] bf16; gate [B, C], wv [9, C], lam, scale, bias [C]
// fp32.  C % 8 == 0, else cudaErrorInvalidValue.
extern "C" int mrla_block_tail_bf16(const void* z, const void* id,
                                    const void* gate, const void* wv,
                                    const void* lam, const void* scale,
                                    const void* bias, void* y, int B, int H,
                                    int W, int C, void* stream) {
  if (C <= 0 || C % 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const TailArgs a = tail_args(z, id, gate, wv, lam, scale, bias, H, W, C);
  return (int)with_ring(W, [&](auto kernel, size_t smem, int) {
    return launch_window(kernel, kThreads, smem, kMaxSegment, a, y, B,
                         static_cast<cudaStream_t>(stream));
  });
}

// What the launch at [B, H, W, C] is: out[0] the segment length (pixels a
// thread walks), out[1] threads a block, out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] blocks, out[4]
// columns in a thread's ring.
extern "C" int mrla_block_tail_describe(int B, int H, int W, int C,
                                        int* out) {
  if (C <= 0 || C % 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  return (int)with_ring(W, [&](auto kernel, size_t smem, int stages) {
    return describe_window(kernel, kThreads, smem, stages, kMaxSegment, B, H,
                           W, C, out);
  });
}
