// Multi-level aligned RoIAlign forward and backward, CUDA C++ for sm_90a.
//
// The forward replaces the TPU kernel mrla_tpu/kernels/roialign_patch.py
// (_fwd_call -> _kernel, reached through roi_align_patch).  For every roi and output bin
// it averages gy x gx bilinear samples of the roi's pyramid level
// (mmdet SingleRoIExtractor with RoIAlign(aligned=True); sampling_ratio=0
// gives each roi its own adaptive gy, gx):
//
//     out[r, oy, ox, c] = valid[r] * sum_{i<gy, j<gx} sum_{4 corners}
//                         wy * wx * feat[level][b, y, x, c]
//
// with the border rules of detect/roi_align.py (a sample outside [-1, n]
// adds zero, one inside is clamped to [0, n - 1]) and the slot average
// (i < g) / g folded into the weights.
//
// The per-roi geometry (level, aligned corner, bin sizes, gy, gx, valid)
// is computed once in PyTorch (detect/roi_align.py:roi_geometry) and read
// here as 8 floats a roi, so this kernel and its plain version share every
// level decision and sample count.
//
// What bounds it on an H100: a gather.  At the detection path's shape (8
// images x 1000 rois, 7 x 7 bins, C = 256, bf16 pyramid 800 x 1344) the
// output is 200 MB and the rois' footprints on the 365 MB pyramid are read
// once at best (about 0.1 ms of HBM time), while the samples ask for some
// 4 x gy x gx x 512 bytes per bin and roi from L1 / L2: the kernel is
// bound by how fast it turns dependent, scattered 16-byte loads into fp32
// sums, not by device memory.
//
// Design (simple first): one block per roi.  Its threads first build the
// roi's two axis tables in shared memory (for each bin and sample slot:
// low and high cell, and their weights), then loop over (bin, 8 channels)
// items with a warp covering 32 x 8 consecutive channels of one bin: each
// sample is four 16-byte (bf16) or 32-byte (fp32) loads along C, each
// output one coalesced store.  There is no patch: the TPU kernel copies a
// 56-cell patch into VMEM and contracts with two weight matrices (and
// drops what lies outside the patch); here every sample reads the level
// through L1 / L2, so any roi size is exact.  Sums are fp32 in another
// order than the plain version's.  Features and output are both bf16 or
// both fp32: the detection path reads the bf16 pyramid and writes the bf16
// head input directly (widening bf16 to fp32 is exact, so that is the same
// function as the JAX path's fp32 cast before and bf16 cast after).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
constexpr int kGeom = 8;  // y1, x1, bin_y, bin_x, gy, gx, valid, level

struct Levels {
  const void* base[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

struct Vec8 {
  float v[8];
};

__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  Vec8 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    r.v[2 * k] = f.x;
    r.v[2 * k + 1] = f.y;
  }
  return r;
}

__device__ __forceinline__ Vec8 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return Vec8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One sample slot of one axis: its two cells and their weights.
struct Tap {
  int lo, hi;
  float wlo, whi;
};

// The slot (o, i) of an axis, exactly as detect/roi_align.py:axis_samples
// computes it (no contraction into FMAs, IEEE division).
__device__ __forceinline__ Tap axis_tap(float start, float bin, float g,
                                        int n, int o, int i) {
  const float inner = __fdiv_rn((float)i + 0.5f, g);
  const float frac = __fadd_rn((float)o, inner);
  const float t = __fadd_rn(start, __fmul_rn(frac, bin));
  const float slot_w = ((float)i < g) ? __fdiv_rn(1.f, g) : 0.f;
  const float nf = (float)n;
  const bool ok = t >= -1.f && t <= nf;
  const float tc = fminf(fmaxf(t, 0.f), nf - 1.f);
  const float lo = floorf(tc);
  const float hi = fminf(lo + 1.f, nf - 1.f);
  const float w_hi = tc - lo;
  Tap tap;
  tap.lo = (int)lo;
  tap.hi = (int)hi;
  tap.wlo = ok ? (1.f - w_hi) * slot_w : 0.f;
  tap.whi = ok ? w_hi * slot_w : 0.f;
  return tap;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(Levels lv, const float* __restrict__ geom,
                     T* __restrict__ out, int P, int C, int O, int smax) {
  extern __shared__ Tap taps[];  // [2][O][smax]: y axis, then x axis
  const int64_t r = blockIdx.x;
  const float* gm = geom + r * kGeom;
  const float valid = gm[6];
  const int items = O * O * (C / 8);
  T* out_r = out + r * (int64_t)O * O * C;

  if (valid == 0.f) {  // invalid rows are zero
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int it = threadIdx.x; it < items; it += kThreads)
      store8(out_r + (int64_t)it * 8, zero);
    return;
  }
  const int level = (int)gm[7];
  const int H = lv.H[level], W = lv.W[level];
  const float gy = gm[4], gx = gm[5];
  for (int k = threadIdx.x; k < 2 * O * smax; k += kThreads) {
    const int axis = k / (O * smax);
    const int o = (k / smax) % O;
    const int i = k % smax;
    taps[k] = axis == 0 ? axis_tap(gm[0], gm[2], gy, H, o, i)
                        : axis_tap(gm[1], gm[3], gx, W, o, i);
  }
  __syncthreads();

  const T* base = static_cast<const T*>(lv.base[level]) +
                  (r / P) * (int64_t)H * W * C;
  const int ny = (int)gy, nx = (int)gx;
  const int groups = C / 8;
  const Tap* ty = taps;
  const Tap* tx = taps + O * smax;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int bin = it / groups;
    const int c0 = (it % groups) * 8;
    const int oy = bin / O, ox = bin % O;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < ny; ++i) {
      const Tap a = ty[oy * smax + i];
      if (a.wlo == 0.f && a.whi == 0.f) continue;
      const T* row_lo = base + (int64_t)a.lo * W * C + c0;
      const T* row_hi = base + (int64_t)a.hi * W * C + c0;
      for (int j = 0; j < nx; ++j) {
        const Tap b = tx[ox * smax + j];
        if (b.wlo == 0.f && b.whi == 0.f) continue;
        const Vec8 v00 = load8(row_lo + (int64_t)b.lo * C);
        const Vec8 v01 = load8(row_lo + (int64_t)b.hi * C);
        const Vec8 v10 = load8(row_hi + (int64_t)b.lo * C);
        const Vec8 v11 = load8(row_hi + (int64_t)b.hi * C);
        const float w00 = a.wlo * b.wlo, w01 = a.wlo * b.whi;
        const float w10 = a.whi * b.wlo, w11 = a.whi * b.whi;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[k] += w00 * v00.v[k] + w01 * v01.v[k] + w10 * v10.v[k] +
                    w11 * v11.v[k];
      }
    }
    store8(out_r + (int64_t)bin * C + c0, acc);
  }
}

template <typename T>
cudaError_t launch(const Levels& lv, const float* geom, void* out, int R,
                   int P, int C, int O, int smax, cudaStream_t stream) {
  const size_t smem = sizeof(Tap) * 2 * O * smax;
  if (R > 0)
    roi_align_kernel<T><<<R, kThreads, smem, stream>>>(
        lv, geom, static_cast<T*>(out), P, C, O, smax);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernel mrla_tpu/kernels/roialign_patch.py (_bwd_call ->
// _bwd_kernel, the custom VJP of roi_align_patch): the transpose of the
// forward above.  For every valid roi, bin (oy, ox), sample slot (i, j) and
// corner
//
//     grad[level][b, y, x, c] += wy * wx * g[r, oy, ox, c]
//
// with the forward's own taps (axis_tap: border rules, slot weights), read
// from the same geometry rows, so the level and the sample counts are the
// forward's.  Nothing goes to the rois or to valid.
//
// A bin's slots along one axis touch few distinct cells (gy + 1 at most on
// the adaptive grid, whose samples lie at most one cell apart; 2 * gy in
// general): the block first sums each bin's slot weights per cell (one row
// of the TPU kernel's Ay / Ax matrices, kept sparse), so a bin scatters
// wy(y) * wx(x) * g to at most (gy + 1)(gx + 1) cells instead of adding
// 4 * gy * gx corner terms.
//
// What bounds it on an H100: the zero-filled fp32 gradient buffers (the
// wrapper's, 435 MB for P2..P5 at 800 x 800, batch 8) and the atomic
// read-modify-writes into the rois' footprints, which resolve in L2.  The
// TPU kernel avoids write races because its grid runs the rois one after
// another (a read-modify-write DMA of a patch per roi); here blocks run in
// no order on 132 SMs and neighbouring rois and bins overlap, so every add
// is an fp32 atomic, 16 bytes at a time (atomicAdd on float4, sm_90).  The
// sums therefore land in a different order from run to run: the result is
// deterministic to fp32 rounding only.
//
// Design (simple first): one block per roi; threads loop over (bin, 8
// channels) items, a warp covering 32 x 8 consecutive channels of one bin:
// two 16-byte loads of the cotangent, then two 16-byte atomics per cell.

struct GradLevels {
  float* base[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// One cell of a bin along one axis and the summed weight of its slots.
struct Cell {
  int idx;
  float w;
};

__device__ __forceinline__ void add_cell(Cell* cells, int& m, int idx,
                                         float w) {
  if (w == 0.f) return;
  for (int k = 0; k < m; ++k)
    if (cells[k].idx == idx) {
      cells[k].w += w;
      return;
    }
  cells[m++] = Cell{idx, w};
}

__device__ __forceinline__ void red_add8(float* p, float w, const float* g) {
  float4* q = reinterpret_cast<float4*>(p);
  atomicAdd(q, make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
  atomicAdd(q + 1, make_float4(w * g[4], w * g[5], w * g[6], w * g[7]));
}

__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(GradLevels lv, const float* __restrict__ geom,
                         const float* __restrict__ grad, int P, int C, int O,
                         int smax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = 2 * smax;  // cells a bin can touch along one axis
  Cell* cells = reinterpret_cast<Cell*>(smem_raw);  // [2][O][K]: y, then x
  int* counts = reinterpret_cast<int*>(cells + 2 * O * K);  // [2][O]
  const int64_t r = blockIdx.x;
  const float* gm = geom + r * kGeom;
  if (gm[6] == 0.f) return;  // invalid rois add nothing
  const int level = (int)gm[7];
  const int H = lv.H[level], W = lv.W[level];
  for (int k = threadIdx.x; k < 2 * O; k += kThreads) {
    const int axis = k / O, o = k % O;
    const float g = gm[4 + axis];
    const int n = axis == 0 ? H : W;
    const int ng = min((int)g, smax);
    Cell* row = cells + k * K;
    int m = 0;
    for (int i = 0; i < ng; ++i) {
      const Tap t = axis_tap(gm[axis], gm[2 + axis], g, n, o, i);
      add_cell(row, m, t.lo, t.wlo);
      add_cell(row, m, t.hi, t.whi);
    }
    counts[k] = m;
  }
  __syncthreads();

  float* base = lv.base[level] + (r / P) * (int64_t)H * W * C;
  const float* g_r = grad + r * (int64_t)O * O * C;
  const int groups = C / 8;
  const int items = O * O * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int bin = it / groups;
    const int c0 = (it % groups) * 8;
    const int oy = bin / O, ox = bin % O;
    const Vec8 gv = load8(g_r + (int64_t)bin * C + c0);
    const Cell* cy = cells + oy * K;
    const Cell* cx = cells + (O + ox) * K;
    const int ny = counts[oy], nx = counts[O + ox];
    for (int a = 0; a < ny; ++a) {
      float* row = base + (int64_t)cy[a].idx * W * C + c0;
      for (int b = 0; b < nx; ++b)
        red_add8(row + (int64_t)cx[b].idx * C, cy[a].w * cx[b].w, gv.v);
    }
  }
}

size_t bwd_smem_bytes(int O, int smax) {
  return sizeof(Cell) * 2 * O * 2 * smax + sizeof(int) * 2 * O;
}

}  // namespace

// feats: L (1..4) levels [B, H_l, W_l, C] NHWC contiguous, 16-byte aligned;
// geom [B * P, 8] fp32; out [B, P, O, O, C] in the features' dtype: bf16
// if bf16 is 1, fp32 if it is 0.  C % 8 == 0, O >= 1, 1 <= smax and
// 2 * O * smax taps within 48 KB of shared memory, else
// cudaErrorInvalidValue.
extern "C" int roi_align_fwd(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int L,
                             const void* geom, void* out, int B, int P,
                             int C, int O, int smax, int bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || C <= 0 || C % 8 || O < 1 || smax < 1 ||
      sizeof(Tap) * 2 * O * smax > 48 * 1024 || B < 0 || P < 0 ||
      (int64_t)B * P > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const float* g = static_cast<const float*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * P;
  return (int)(bf16 ? launch<__nv_bfloat16>(lv, g, out, R, P, C, O, smax, s)
                    : launch<float>(lv, g, out, R, P, C, O, smax, s));
}

// The backward.  grad0..grad3: L (1..4) fp32 gradient buffers [B, H_l, W_l,
// C], NHWC contiguous, 16-byte aligned, zero-filled by the caller (the
// kernel adds into them); geom [B * P, 8] fp32, the forward's; g the fp32
// cotangent [B, P, O, O, C], contiguous.  C % 8 == 0, O >= 1, 1 <= smax
// and the cell tables within 48 KB of shared memory, else
// cudaErrorInvalidValue.
extern "C" int roi_align_bwd(void* grad0, void* grad1, void* grad2,
                             void* grad3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int L,
                             const void* geom, const void* g, int B, int P,
                             int C, int O, int smax, void* stream) {
  if (L < 1 || L > kMaxLevels || C <= 0 || C % 8 || O < 1 || smax < 1 ||
      bwd_smem_bytes(O, smax) > 48 * 1024 || B < 0 || P < 0 ||
      (int64_t)B * P > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  GradLevels lv{{static_cast<float*>(grad0), static_cast<float*>(grad1),
                 static_cast<float*>(grad2), static_cast<float*>(grad3)},
                {h0, h1, h2, h3},
                {w0, w1, w2, w3}};
  const int R = B * P;
  if (R > 0)
    roi_align_bwd_kernel<<<R, kThreads, bwd_smem_bytes(O, smax),
                           static_cast<cudaStream_t>(stream)>>>(
        lv, static_cast<const float*>(geom), static_cast<const float*>(g), P,
        C, O, smax);
  return (int)cudaGetLastError();
}
