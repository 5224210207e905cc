// Designs of the RoIAlign forward (csrc/roi_align.cu) side by side, for
// tune_roi_align_fwd.py: the library's per-bin separable kernel; the row
// walk, the design first tried for it (a thread per (group of OC output
// rows, output column, 8 channels) keeping OC sums in registers and walking
// the group's y cells, each feature row contracted once over the column's
// x cells), at three shapes; and the gather kernel the library replaced (a
// block per roi, each (bin, 8 channels) item summing 4 gy gx corner
// loads).  Built by that script, not into the kernel library.
#include "roi_align.cu"

namespace {

// One cell list of a roi, built by one warp: the cells e of an axis on
// which any of the nb bins (their slots' taps at bins[j * smax + i]) puts a
// weight, in increasing order, into cell[0..n), and bin j's weight on the
// k-th of them into w[j * stride + k]: the sum of its slots' weights on
// that cell in slot order, low then high neighbour, as the backward's
// axis_bins sums them.  Returns n to every lane.
template <int NB>
__device__ int cell_list(const Tap* bins, int nb, int smax, int* cell,
                         float* w, int stride) {
  const int lane = threadIdx.x & 31;
  int lo = 0x7fffffff, hi = -1;
  for (int k = lane; k < nb * smax; k += 32) {
    const Tap t = bins[k];
    if (t.wlo != 0.f) lo = min(lo, t.lo), hi = max(hi, t.lo);
    if (t.whi != 0.f) lo = min(lo, t.hi), hi = max(hi, t.hi);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  int n = 0;
  for (int e0 = lo; e0 <= hi; e0 += 32) {
    const int e = e0 + lane;
    float we[NB];
    bool any = false;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      we[j] = 0.f;
      if (j < nb && e <= hi) {
        for (int i = 0; i < smax; ++i) {
          const Tap t = bins[j * smax + i];
          if (t.lo == e) we[j] += t.wlo;
          if (t.hi == e) we[j] += t.whi;
        }
        any |= we[j] != 0.f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, any);
    if (any) {
      const int at = n + __popc(mask & ((1u << lane) - 1u));
      cell[at] = e;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < nb) w[j * stride + at] = we[j];
    }
    n += __popc(mask);
  }
  return n;
}

// The row walk's shape: OC output rows a thread (their sums in registers)
// and at most THREADS threads a block.
template <int OC_, int THREADS_>
struct WalkShape {
  static constexpr int OC = OC_, THREADS = THREADS_;
};

// A launch at O x O bins: G groups of OC output rows; each (group, output
// column) item walked by `lanes` threads of 8 channels, `slices` blocks a
// roi along C; threads a block, cells a list (xm along x, rm along y) and
// shared memory bytes.
struct FwdPlan {
  int G, lanes, slices, threads, xm, rm;
  size_t smem;
};

template <class S>
FwdPlan fwd_plan(int C, int O, int smax) {
  FwdPlan p;
  p.G = (O + S::OC - 1) / S::OC;
  p.lanes = 1;
  while (2 * p.lanes <= C / 8 && p.G * O * 2 * p.lanes <= S::THREADS)
    p.lanes *= 2;
  p.slices = (C / 8 + p.lanes - 1) / p.lanes;
  p.threads = min(S::THREADS, (p.G * O * p.lanes + 31) / 32 * 32);
  p.xm = 2 * smax;  // a bin's slots reach at most 2 g cells
  p.rm = 2 * smax * S::OC;
  p.smem = sizeof(Tap) * 2 * O * smax +
           (sizeof(int) + sizeof(float)) * (size_t)O * p.xm +
           (sizeof(int) + sizeof(float) * S::OC) * (size_t)p.G * p.rm +
           sizeof(int) * (O + p.G);
  return p;
}

// A block per (roi, channel slice).  Its threads build the roi's tables
// (the taps of both axes; per output column ox the x cells its bin weighs
// and their weights; per group of OC output rows the y cells any of them
// weighs and each row's weights), then each (group, ox, 8 channels) item
// walks its group's y cells in order: the x contraction of that feature
// row over ox's cells, then one fma into each of its OC sums.
template <typename T, class S>
__global__ void __launch_bounds__(S::THREADS)
    rowwalk_kernel(Levels lv, const float* __restrict__ geom,
                         T* __restrict__ out, int P, int C, int O, int smax,
                         FwdPlan p) {
  constexpr int OC = S::OC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tap* taps = reinterpret_cast<Tap*>(smem_raw);  // [2][O][smax]: y, x
  int* xcell = reinterpret_cast<int*>(taps + 2 * O * smax);  // [O][xm]
  float* xw = reinterpret_cast<float*>(xcell + O * p.xm);    // [O][xm]
  int* ycell = reinterpret_cast<int*>(xw + O * p.xm);        // [G][rm]
  float* yw = reinterpret_cast<float*>(ycell + p.G * p.rm);  // [G][OC][rm]
  int* counts = reinterpret_cast<int*>(yw + p.G * OC * p.rm);  // [O + G]
  const int64_t r = blockIdx.x;
  const float* gm = geom + r * kGeom;
  T* out_r = out + r * (int64_t)O * O * C;

  if (gm[6] == 0.f) {  // invalid rows are zero
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int it = threadIdx.x; it < O * O * p.lanes; it += blockDim.x) {
      const int c0 = (blockIdx.y * p.lanes + it % p.lanes) * 8;
      if (c0 < C) store8(out_r + (int64_t)(it / p.lanes) * C + c0, zero);
    }
    return;
  }
  const int level = (int)gm[7];
  const int H = lv.H[level], W = lv.W[level];
  for (int k = threadIdx.x; k < 2 * O * smax; k += blockDim.x) {
    const int axis = k / (O * smax);
    const int o = (k / smax) % O;
    const int i = k % smax;
    taps[k] = axis == 0 ? axis_tap(gm[0], gm[2], gm[4], H, o, i)
                        : axis_tap(gm[1], gm[3], gm[5], W, o, i);
  }
  __syncthreads();
  // list q, a warp each: q < O the x cells of output column q, else the y
  // cells of group q - O
  for (int q = threadIdx.x / 32; q < O + p.G; q += blockDim.x / 32) {
    int n;
    if (q < O) {
      n = cell_list<1>(taps + (O + q) * smax, 1, smax, xcell + q * p.xm,
                       xw + q * p.xm, 0);
    } else {
      const int g = q - O;
      n = cell_list<OC>(taps + g * OC * smax, min(OC, O - g * OC), smax,
                        ycell + g * p.rm, yw + g * OC * p.rm, p.rm);
    }
    if ((threadIdx.x & 31) == 0) counts[q] = n;
  }
  __syncthreads();

  const T* base = static_cast<const T*>(lv.base[level]) +
                  (r / P) * (int64_t)H * W * C;
  for (int it = threadIdx.x; it < p.G * O * p.lanes; it += blockDim.x) {
    const int c0 = (blockIdx.y * p.lanes + it % p.lanes) * 8;
    const int ox = it / p.lanes % O, g = it / (p.lanes * O);
    if (c0 >= C) continue;
    const int nx = counts[ox], ny = counts[O + g];
    const int* xc = xcell + ox * p.xm;
    const float* xwt = xw + ox * p.xm;
    const int* yc = ycell + g * p.rm;
    const float* ywt = yw + g * OC * p.rm;
    float acc[OC][8];
#pragma unroll
    for (int j = 0; j < OC; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;
    for (int k = 0; k < ny; ++k) {
      const T* row = base + (int64_t)yc[k] * W * C + c0;
      float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int m = 0; m < nx; ++m) {
        const Vec8 v = load8(row + (int64_t)xc[m] * C);
        const float a = xwt[m];
#pragma unroll
        for (int c = 0; c < 8; ++c) t[c] = fmaf(a, v.v[c], t[c]);
      }
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float a = ywt[j * p.rm + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(a, t[c], acc[j][c]);
      }
    }
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int oy = g * OC + j;
      if (oy < O) store8(out_r + ((int64_t)oy * O + ox) * C + c0, acc[j]);
    }
  }
}

// The row walk of shape S over R = B x P rois, with roi_align_fwd's
// arguments.
template <typename T, class S>
cudaError_t launch_rowwalk(const Levels& lv, const float* geom, void* out,
                       int R, int P, int C, int O, int smax,
                       cudaStream_t stream) {
  const FwdPlan p = fwd_plan<S>(C, O, smax);
  if (p.smem > kMaxDynamicSmem || p.slices > 65535)
    return cudaErrorInvalidValue;
  if (R == 0 || C == 0) return cudaSuccess;
  auto kernel = rowwalk_kernel<T, S>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((unsigned)R, (unsigned)p.slices), p.threads, p.smem,
           stream>>>(lv, geom, static_cast<T*>(out), P, C, O, smax, p);
  return cudaGetLastError();
}



template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(Levels lv, const float* __restrict__ geom,
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
cudaError_t launch_gather(const Levels& lv, const float* geom, void* out,
                          int R, int P, int C, int O, int smax,
                          cudaStream_t stream) {
  const size_t smem = sizeof(Tap) * 2 * O * smax;
  if (R > 0)
    gather_kernel<T><<<R, kThreads, smem, stream>>>(
        lv, geom, static_cast<T*>(out), P, C, O, smax);
  return cudaGetLastError();
}

constexpr int kGather = 4;

// variant 1..3 -> f(tag of the row walk's shape)
template <class F>
int with_shape(int v, F&& f) {
  switch (v) {
    case 1: return f(WalkShape<7, 256>{});
    case 2: return f(WalkShape<4, 256>{});
    case 3: return f(WalkShape<2, 256>{});
    default: return -1;
  }
}

// variant 5.. -> f(tag of a launch of the library's kernel)
template <class F>
int with_launch(int v, F&& f) {
  switch (v) {
    case 5: return f(FwdShape<256, 1, 2>{});
    case 6: return f(FwdShape<256, 1, 4>{});
    case 7: return f(FwdShape<256, 2, 2>{});
    case 8: return f(FwdShape<256, 2, 4>{});
    case 9: return f(FwdShape<256, 4, 2>{});
    case 10: return f(FwdShape<128, 4, 4>{});
    case 11: return f(FwdShape<256, 1, 1>{});
    default: return -1;
  }
}

}  // namespace

// The forward of variant v (0 the library's kernel, 1..3 the row walk,
// kGather the gather kernel, 5.. other launches of the library's kernel)
// with roi_align_fwd's arguments.
extern "C" int tune_roi_fwd(int v, const void* f0, const void* f1,
                            const void* f2, const void* f3, int h0, int w0,
                            int h1, int w1, int h2, int w2, int h3, int w3,
                            int L, const void* geom, void* out, int B, int P,
                            int C, int O, int smax, int bf16, void* stream) {
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const float* g = static_cast<const float*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * P;
  if (v == 0)
    return roi_align_fwd(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, L,
                         geom, out, B, P, C, O, smax, bf16, stream);
  if (v > kGather)
    return with_launch(v, [&](auto shape) {
      using S = decltype(shape);
      return (int)(bf16 ? launch_fwd<__nv_bfloat16, S>(lv, g, out, R, P, C,
                                                       O, smax, s)
                        : launch_fwd<float, S>(lv, g, out, R, P, C, O, smax,
                                               s));
    });
  if (v == kGather)
    return (int)(bf16 ? launch_gather<__nv_bfloat16>(lv, g, out, R, P, C, O,
                                                     smax, s)
                      : launch_gather<float>(lv, g, out, R, P, C, O, smax,
                                             s));
  return with_shape(v, [&](auto shape) {
    using S = decltype(shape);
    return (int)(bf16 ? launch_rowwalk<__nv_bfloat16, S>(lv, g, out, R, P,
                                                         C, O, smax, s)
                      : launch_rowwalk<float, S>(lv, g, out, R, P, C, O,
                                                 smax, s));
  });
}

// out[0..3] of variant v at C, O, smax: groups of output rows, threads a
// block, blocks a roi, shared memory bytes.
extern "C" int tune_roi_fwd_plan(int v, int C, int O, int smax, int* out) {
  if (v > kGather)
    return with_launch(v, [&](auto shape) {
      out[0] = 1;
      out[1] = decltype(shape)::NT;
      out[2] = 1;
      out[3] = (int)fwd_smem_bytes(O, smax);
      return 0;
    });
  if (v == 0 || v == kGather) {
    out[0] = 1;
    out[1] = v == 0 ? FwdLib::NT : kThreads;
    out[2] = 1;
    out[3] = (int)(v == 0 ? fwd_smem_bytes(O, smax)
                          : sizeof(Tap) * 2 * O * smax);
    return 0;
  }
  return with_shape(v, [&](auto shape) {
    const FwdPlan p = fwd_plan<decltype(shape)>(C, O, smax);
    out[0] = p.G;
    out[1] = p.threads;
    out[2] = p.slices;
    out[3] = (int)p.smem;
    return 0;
  });
}
