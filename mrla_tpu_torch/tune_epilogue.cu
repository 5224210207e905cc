// Designs of the MRLA-light epilogue (csrc/mrla_epilogue.cu) side by side,
// for tune_epilogue.py: tail_window.cuh's sliding window over FromOut
// columns with the window as fp32 or as packed bf16, at 64 and 128 threads
// a block and rings of 2 to 8 columns, each with a segment length given per
// launch; and the per-vector kernel the window replaced (a thread per 8
// channels of one pixel, mrla_tail.cuh's mrla_tail_y8: the parent's
// library kernel, kept here for side-by-side timing and as the bitwise
// yardstick).  Built by that script, not into the kernel library.
#include "mrla_epilogue.cu"

namespace {

__global__ void __launch_bounds__(256)
    epilogue_vectors(TailArgs a, __nv_bfloat16* __restrict__ y,
                     int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = a.C / 8;
  const int64_t p = i / vecs;
  const int c0 = (int)(i % vecs) * 8;
  *reinterpret_cast<uint4*>(y + p * a.C + c0) = mrla_tail_y8(a, p, c0);
}

constexpr int kVectors = 11;

// variant -> f(kernel, threads a block, ring columns, packed window)
template <class F>
int with_variant(int v, F&& f) {
  switch (v) {
    case 0: return f(tail_window_kernel<FromOut, false, 64, 2>, 64, 2, 0);
    case 1: return f(tail_window_kernel<FromOut, false, 64, 3>, 64, 3, 0);
    case 2: return f(tail_window_kernel<FromOut, false, 64, 4>, 64, 4, 0);
    case 3: return f(tail_window_kernel<FromOut, false, 64, 6>, 64, 6, 0);
    case 4: return f(tail_window_kernel<FromOut, false, 64, 8>, 64, 8, 0);
    case 5: return f(tail_window_kernel<FromOut, false, 128, 4>, 128, 4, 0);
    case 6: return f(tail_window_kernel<FromOut, true, 64, 2>, 64, 2, 1);
    case 7: return f(tail_window_kernel<FromOut, true, 64, 4>, 64, 4, 1);
    case 8: return f(tail_window_kernel<FromOut, true, 64, 8>, 64, 8, 1);
    case 9: return f(tail_window_kernel<FromOut, true, 128, 4>, 128, 4, 1);
    case 10: return f(tail_window_kernel<FromOut, true, 128, 8>, 128, 8, 1);
    default: return -1;
  }
}

}  // namespace

// y at [B, H, W, C] with variant v walking segments of seg pixels
// (kVectors: the per-vector kernel, seg ignored).
extern "C" int tune_epilogue(int v, int seg, const void* out, const void* id,
                             const void* gate, const void* wv,
                             const void* lam, const void* scale,
                             const void* bias, void* y, int B, int H, int W,
                             int C, void* stream) {
  const TailArgs a = tail_args(out, id, gate, wv, lam, scale, bias, H, W, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == kVectors) {
    const int64_t n = (int64_t)B * H * W * (C / 8);
    if (n > 0)
      epilogue_vectors<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
          a, static_cast<__nv_bfloat16*>(y), n);
    return (int)cudaGetLastError();
  }
  return with_variant(v, [&](auto kernel, int nt, int stages, int) {
    return (int)launch_window(kernel, nt, ring_bytes<FromOut>(nt, stages),
                              seg, a, y, B, s);
  });
}

// out[0] blocks an SM of variant v
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its threads a
// block, out[2] its shared memory bytes, out[3] ring columns, out[4] 1 for
// a packed window; raises the kernel's dynamic shared memory limit where
// the ring needs more than 48 KB.
extern "C" int tune_epilogue_describe(int v, int* out) {
  if (v == kVectors) {
    out[1] = 256;
    out[2] = out[3] = out[4] = 0;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, epilogue_vectors, 256, 0);
  }
  return with_variant(v, [&](auto kernel, int nt, int stages, int packed) {
    const size_t smem = ring_bytes<FromOut>(nt, stages);
    out[1] = nt;
    out[2] = (int)smem;
    out[3] = stages;
    out[4] = packed;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, nt,
                                                              smem);
  });
}
