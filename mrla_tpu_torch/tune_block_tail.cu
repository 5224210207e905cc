// Designs of the block tail from z (csrc/mrla_block_tail.cu) side by side,
// for tune_block_tail.py: the sliding window with its cp.async ring at
// several block sizes and ring depths (the library's two first), each with a
// segment length given per launch; the same window with its next column's
// loads held in registers (one column ahead, 256 threads); and the
// per-vector kernel the window replaced (a thread per 8 channels of one
// pixel, mrla_tail.cuh's mrla_block_tail_y8).  Built by that script, not
// into the kernel library.
#include "mrla_block_tail.cu"

namespace {

__global__ void __launch_bounds__(256)
    block_tail_vectors(TailArgs a, __nv_bfloat16* __restrict__ y,
                       int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = a.C / 8;
  const int64_t p = i / vecs;
  const int c0 = (int)(i % vecs) * 8;
  *reinterpret_cast<uint4*>(y + p * a.C + c0) = mrla_block_tail_y8(a, p, c0);
}

// The window with the loads of the column after next in registers.
__global__ void __launch_bounds__(256)
    block_tail_registers(TailArgs a, __nv_bfloat16* __restrict__ y,
                         int64_t n_items, int seg, int segs) {
  const int64_t item = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (item >= n_items) return;
  const int vecs = a.C >> 3;
  const int64_t s = item / vecs;
  const int c0 = (int)(item - s * vecs) * 8;
  const int64_t row = s / segs;  // image * H + h
  const int64_t img = row / a.H;
  const int h = (int)(row - img * a.H);
  const int w0 = (int)(s - row * segs) * seg, w1 = min(w0 + seg, a.W);
  const bool top = h > 0, bottom = h + 1 < a.H;
  const int64_t top_row = (row - 1) * a.W * (int64_t)a.C + c0;
  float wv[9][8], lam[8], sc[8], bi[8], gate[8];
  load_constants(a, c0, img, wv, lam, sc, bi, gate);
  auto load = [&](int col, uint4 (&z)[3], uint4 (&id)[3]) {
    const bool live = col >= 0 && col < a.W && col <= w1;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool ok = live && (r != 0 || top) && (r != 2 || bottom);
      const int64_t at = top_row + ((int64_t)r * a.W + col) * a.C;
      z[r] = ok ? __ldg(reinterpret_cast<const uint4*>(a.out + at))
                : make_uint4(0u, 0u, 0u, 0u);
      id[r] = ok ? __ldg(reinterpret_cast<const uint4*>(a.id + at))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  float win[3][3][8];
  uint4 idc[3], pz[3], pi[3];
  load(w0 - 1, pz, pi);
#pragma unroll
  for (int r = 0; r < 3; ++r) form_x(pz[r], pi[r], win[0][r]);
  load(w0, pz, pi);
#pragma unroll
  for (int r = 0; r < 3; ++r) form_x(pz[r], pi[r], win[1][r]);
  idc[1] = pi[1];
  load(w0 + 1, pz, pi);
  __nv_bfloat16* yrow = y + row * a.W * (int64_t)a.C + c0;
  for (int w = w0; w < w1; w += 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = w + k;
      if (p >= w1) break;
#pragma unroll
      for (int r = 0; r < 3; ++r) form_x(pz[r], pi[r], win[(k + 2) % 3][r]);
      idc[(k + 2) % 3] = pi[1];
      load(p + 2, pz, pi);
      *reinterpret_cast<uint4*>(yrow + (int64_t)p * a.C) =
          window_y(win[k % 3], win[(k + 1) % 3], win[(k + 2) % 3],
                   idc[(k + 1) % 3], wv, lam, sc, bi, gate, top, bottom,
                   p > 0, p + 1 < a.W);
    }
  }
}

// variant -> f(kernel, threads a block, ring columns); 6 is the
// per-vector kernel
template <class F>
int with_variant(int v, F&& f) {
  switch (v) {
    case 0: return f(mrla_block_tail_kernel<64, 8>, 64, 8);  // the library's,
    case 1: return f(mrla_block_tail_kernel<64, 4>, 64, 4);  // W >= 28 / < 28
    case 2: return f(mrla_block_tail_kernel<128, 4>, 128, 4);
    case 3: return f(mrla_block_tail_kernel<128, 6>, 128, 6);
    case 4: return f(mrla_block_tail_kernel<256, 6>, 256, 6);
    case 5: return f(block_tail_registers, 256, 0);
    default: return -1;
  }
}

}  // namespace

// y at [B, H, W, C] with variant v walking segments of seg pixels (6: the
// per-vector kernel, seg ignored).
extern "C" int tune_block_tail(int v, int seg, const void* z, const void* id,
                               const void* gate, const void* wv,
                               const void* lam, const void* scale,
                               const void* bias, void* y, int B, int H, int W,
                               int C, void* stream) {
  TailArgs a{static_cast<const __nv_bfloat16*>(z),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate), static_cast<const float*>(wv),
             static_cast<const float*>(lam), static_cast<const float*>(scale),
             static_cast<const float*>(bias), H, W, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<__nv_bfloat16*>(y);
  if (v == 6) {
    const int64_t n = (int64_t)B * H * W * (C / 8);
    block_tail_vectors<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(a, out, n);
    return (int)cudaGetLastError();
  }
  const int segs = (W + seg - 1) / seg;
  return with_variant(v, [&](auto kernel, int nt, int stages) {
    const size_t smem = ring_bytes(nt, stages);
    const int64_t items = (int64_t)B * H * segs * (C / 8);
    kernel<<<(unsigned)((items + nt - 1) / nt), nt, smem, s>>>(a, out, items,
                                                               seg, segs);
    return (int)cudaGetLastError();
  });
}

// out[0] blocks an SM of variant v
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its threads a
// block, out[2] its shared memory bytes; raises the kernel's dynamic shared
// memory limit where the ring needs more than 48 KB.
extern "C" int tune_block_tail_describe(int v, int* out) {
  if (v == 6) {
    out[1] = 256;
    out[2] = 0;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, block_tail_vectors, 256, 0);
  }
  return with_variant(v, [&](auto kernel, int nt, int stages) {
    const size_t smem = ring_bytes(nt, stages);
    out[1] = nt;
    out[2] = (int)smem;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, nt,
                                                              smem);
  });
}
