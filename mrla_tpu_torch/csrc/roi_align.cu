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
// What bounds it on an H100: at the detection path's shape (8 images x
// 1000 rois, 7 x 7 bins, C = 256, bf16 pyramid 800 x 1344) the output is
// 200 MB and the rois' footprints on the 365 MB pyramid are read once at
// best (together about 0.11 ms of HBM time); a kernel that sums 4 gy gx
// corner loads a bin asks L1 / L2 for some 4 x gy x gx x 512 bytes per bin
// and roi (3.6 GB at that shape), ten times the footprints.
//
// Design: separable, as the TPU kernel is (Ay [O, cells] . patch . Ax^T).
// A block per roi first builds the roi's axis tables in shared memory: the
// taps of every bin and sample slot (axis_tap, the arithmetic of
// detect/roi_align.py:axis_samples), then, a thread per (axis, bin), the
// cells the bin's slots weigh with their folded weights (a cell's weight
// is the sum of its slots' weights in slot order: a row of the TPU
// kernel's Ay or Ax, over every cell of the level, so any roi size is
// exact and there is no patch to fall out of).  Then each (bin, 8
// channels) item walks its row bin's y cells, two at a time, contracting
// each feature row over its column bin's x cells (16- or 32-byte loads
// along C, both rows' loads issued together) and adding the row sums,
// weighed, into its output, which it stores once.  An item reads ny x nx
// distinct cells (about 3 x 3 on the serving path's proposals), where
// summing corners reads 4 gy gx (18): each footprint cell is read once per
// bin that weighs it, not once per sample and corner.  Every sum runs in a
// fixed order: two launches give the same bits.  (The design first tried,
// a thread keeping a group of output rows' sums in registers while it
// walks the roi's rows once, read each cell once per column bin but held
// too many registers to hide the loads' latency: tune_roi_align_fwd.cu's
// row walk.)  Features and output are both bf16 or both fp32: the
// detection path reads the bf16 pyramid and writes the bf16 head input
// directly (widening bf16 to fp32 is exact, so that is the same function
// as the JAX path's fp32 cast before and bf16 cast after).
//
// Rounding: the plain version sums up to 4 gy gx products; this kernel
// sums, per output, ny <= 2 gy products of rounded row sums of nx <= 2 gx
// products, with folded weights of at most 5 slot terms each (a cell lies
// within one cell of at most 4 slots at slot spacing bin / ceil(bin) >=
// 1 / 2, plus an edge).  Its error is at most (ny + nx + 5 + 5 + 2) fp32
// roundings of max|feature| (the weights of a bin sum to at most 1 along
// each axis): 40 at smax = 7, under the 196 (4 x 7 x 7) that the
// comparison with the plain version allows (chip_smoke.py ROI_FP32_TERMS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
constexpr int kGeom = 8;  // y1, x1, bin_y, bin_x, gy, gx, valid, level
constexpr size_t kMaxDynamicSmem = 232448;  // a block's, on an H100

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

// The cells bin o of an axis weighs, from its slots' taps (taps[0..ng)),
// into cell[0..n) in the order they first appear (increasing where the bin
// runs forward), each with its folded weight in w: the sum of its slots'
// weights on it in slot order, low then high neighbour (the sum
// detect/roi_align.py:axis_weights and the backward's axis_bins take).
// Returns n, at most 2 ng.
__device__ __forceinline__ int bin_cells(const Tap* taps, int ng, int* cell,
                                         float* w) {
  int n = 0;
  for (int i = 0; i < ng; ++i) {
    const Tap t = taps[i];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = s ? t.hi : t.lo;
      const float we = s ? t.whi : t.wlo;
      if (we == 0.f) continue;  // weights are >= 0: no cell cancels
      int k = n - 1;
      while (k >= 0 && cell[k] != e) --k;
      if (k >= 0) {
        w[k] += we;
      } else {
        cell[n] = e;
        w[n++] = we;
      }
    }
  }
  return n;
}

// A block per roi.  Its threads build the roi's tables: the taps of both
// axes, then, a thread per list, for each bin along each axis the cells
// its slots weigh with their folded weights (a row of the TPU kernel's Ay
// or Ax).  Then each (bin, 8 channels) item contracts, for each y cell of
// its row bin in order, that feature row over its column bin's x cells,
// and adds the row sum, weighed, into its output, ROWS rows at a time
// while as many are left, their loads issued together (the sums in the
// same order).  NT threads a block, at least MINB blocks an SM.  FwdLib,
// the library's launch, was chosen by tune_roi_align_fwd.py: the loads'
// latency sets the time, so occupancy decides it; the register cap of 3
// blocks of 256 threads an SM (85 a thread) beat no cap and the caps of 2
// and 4 (64 spills) at every shape of the detection paths.
template <int NT_, int MINB_, int ROWS_>
struct FwdShape {
  static constexpr int NT = NT_, MINB = MINB_, ROWS = ROWS_;
};
using FwdLib = FwdShape<256, 3, 2>;

// Rows ky, ky + 1, ... of an item, R at a time while R are left: each
// row's sum over the x cells (xc, xw; nx of them) of column c0 (col, the
// image's base at c0), added weighed (yw) into acc in row order.  Returns
// the first row left.
template <int R, typename T>
__device__ __forceinline__ int walk_rows(const T* col, int64_t row_stride,
                                         int C, const int* yc,
                                         const float* yw, int ky, int ny,
                                         const int* xc, const float* xw,
                                         int nx, float (&acc)[8]) {
  for (; ky + R <= ny; ky += R) {
    const T* rows[R];
#pragma unroll
    for (int u = 0; u < R; ++u) rows[u] = col + yc[ky + u] * row_stride;
    float t[R][8];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int c = 0; c < 8; ++c) t[u][c] = 0.f;
#pragma unroll 2
    for (int kx = 0; kx < nx; ++kx) {
      const int64_t at = (int64_t)xc[kx] * C;
      Vec8 v[R];
#pragma unroll
      for (int u = 0; u < R; ++u) v[u] = load8(rows[u] + at);
      const float a = xw[kx];
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int c = 0; c < 8; ++c) t[u][c] = fmaf(a, v[u].v[c], t[u][c]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float a = yw[ky + u];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(a, t[u][c], acc[c]);
    }
  }
  return ky;
}

template <typename T, class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
    roi_align_fwd_kernel(Levels lv, const float* __restrict__ geom,
                         T* __restrict__ out, int P, int C, int O,
                         int smax) {
  constexpr int NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xm = 2 * smax;  // a bin's slots weigh at most 2 g cells
  Tap* taps = reinterpret_cast<Tap*>(smem_raw);  // [2][O][smax]: y, x
  int* cells = reinterpret_cast<int*>(taps + 2 * O * smax);  // [2][O][xm]
  float* weights = reinterpret_cast<float*>(cells + 2 * O * xm);
  int* counts = reinterpret_cast<int*>(weights + 2 * O * xm);  // [2][O]
  const int64_t r = blockIdx.x;
  const float* gm = geom + r * kGeom;
  const int items = O * O * (C / 8);
  T* out_r = out + r * (int64_t)O * O * C;

  if (gm[6] == 0.f) {  // invalid rows are zero
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int it = threadIdx.x; it < items; it += NT)
      store8(out_r + (int64_t)it * 8, zero);
    return;
  }
  const int level = (int)gm[7];
  const int H = lv.H[level], W = lv.W[level];
  const T* base = static_cast<const T*>(lv.base[level]) +
                  (r / P) * (int64_t)H * W * C;
  for (int k = threadIdx.x; k < 2 * O * smax; k += NT) {
    const int axis = k / (O * smax);
    const int o = (k / smax) % O;
    const int i = k % smax;
    taps[k] = axis == 0 ? axis_tap(gm[0], gm[2], gm[4], H, o, i)
                        : axis_tap(gm[1], gm[3], gm[5], W, o, i);
  }
  __syncthreads();
  // list q = axis * O + bin; slots past g weigh nothing
  for (int q = threadIdx.x; q < 2 * O; q += NT) {
    const int ng = min((int)gm[4 + q / O], smax);
    counts[q] = bin_cells(taps + q * smax, ng, cells + q * xm,
                          weights + q * xm);
  }
  __syncthreads();

  const int groups = C / 8;
  const int64_t row_stride = (int64_t)W * C;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int bin = it / groups;
    const int c0 = (it % groups) * 8;
    const int oy = bin / O, ox = bin % O;
    const int ny = counts[oy], nx = counts[O + ox];
    const int* yc = cells + oy * xm;
    const float* yw = weights + oy * xm;
    const int* xc = cells + (O + ox) * xm;
    const float* xw = weights + (O + ox) * xm;
    const T* col = base + c0;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int ky = 0;
    if constexpr (S::ROWS >= 4)
      ky = walk_rows<4>(col, row_stride, C, yc, yw, ky, ny, xc, xw, nx, acc);
    if constexpr (S::ROWS >= 2)
      ky = walk_rows<2>(col, row_stride, C, yc, yw, ky, ny, xc, xw, nx, acc);
    walk_rows<1>(col, row_stride, C, yc, yw, ky, ny, xc, xw, nx, acc);
    store8(out_r + (int64_t)bin * C + c0, acc);
  }
}

// The forward's dynamic shared memory at O x O bins and smax slots.
size_t fwd_smem_bytes(int O, int smax) {
  return sizeof(Tap) * 2 * O * smax +
         (sizeof(int) + sizeof(float)) * 2 * O * 2 * (size_t)smax +
         sizeof(int) * 2 * O;
}

// The forward of shape S over R = B x P rois; the arguments are
// roi_align_fwd's, checked there.
template <typename T, class S = FwdLib>
cudaError_t launch_fwd(const Levels& lv, const float* geom, void* out,
                       int R, int P, int C, int O, int smax,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(O, smax);
  if (R == 0) return cudaSuccess;
  auto kernel = roi_align_fwd_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<R, S::NT, smem, stream>>>(lv, geom, static_cast<T*>(out), P, C,
                                     O, smax);
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
// What bounds it on an H100: bytes.  The fp32 gradient of the whole
// pyramid is written once (435 MB for P2..P5 at 800 x 800, batch 8, C =
// 256: 0.13 ms at 3.35 TB/s), most of it zeros, and the valid rois'
// cotangent is read once.
//
// Design: every gradient cell is written once, by the block that owns it,
// with no atomics and no zero-fill.  Two passes:
//
//   1. roi_align_bwd_prep, a block per roi, writes into the scratch buffer
//      (a) the roi's box, every cell its taps can reach (the arithmetic of
//      detect/roi_align.py:roi_footprint, bit for bit); (b) along each axis
//      the box spans more than O cells, for each box cell the bins that
//      reach it and their weights (the slot weights of the bin's taps on
//      that cell, summed in slot order: a row of the TPU kernel's Ay / Ax);
//      (c) the roi's fold: along an axis its box spans at most O cells,
//      its bins are under about a cell wide and each cell takes many (a
//      point-like roi gives each of its 2 x 2 cells all O x O bins), so
//      for each box cell the pass sums its bins' weighted cotangent rows
//      into a scratch copy of the roi's rows, the cell standing where the
//      bin stood.
//   2. roi_align_bwd_tiles, a block per tile of kTH x kTW cells x CS
//      channels of one level of one image (8 VECS channels a thread, the
//      sums in registers; TileShape).  It reads its image's rois a block's
//      threads at a time
//      (the next chunk's boxes loaded while it works on one) and keeps, in
//      roi index order, those of its level whose box meets the tile.  For
//      up to kBatch of them at a time it copies, per tile row and per tile
//      column, the cell's bins and weights from (b) into shared memory, or
//      along a folded axis the cell's own row of (c) with weight 1; then
//      each thread adds wy * wx * g[r, oy, ox, c] for its cell's bins (1
//      or 2 a folded roi), the cotangent read with 16-byte loads, VECS of
//      them in flight, on CHAINS chains of sums (the batch's rois taken
//      in turn, added at the end).  Finally the block stores its tile
//      once, zeros included.  Tiles are numbered from the top level down:
//      the coarse levels' tiles meet the most rois and start first.
//
// Every sum runs in a fixed order (on each chain rois, then oy, then ox;
// the tables' and the fold's likewise), so two launches give the same bits.

constexpr int kTH = 8, kTW = 8;  // cells a tile
constexpr int kBatch = 16;  // rois a table copy at most (fewer at large O)

// The tile pass's shape: CS channels a block, VECS 8-channel vectors a
// thread, CHAINS chains of sums a thread (tune_roi_align_bwd.py compares
// shapes; LibTile is the one the library launches).
template <int CS_, int VECS_, int CHAINS_>
struct TileShape {
  static constexpr int CS = CS_, VECS = VECS_, CHAINS = CHAINS_;
  static constexpr int LANES = CS / (8 * VECS);  // threads a cell
  static constexpr int THREADS = kTH * kTW * LANES;
  static constexpr int CHUNK = THREADS;  // rois a scan
  static constexpr int WARPS = THREADS / 32;
  // the tile kernel's static shared memory (list, boxes, warp_hits,
  // from_fold), and what of 48 KB its dynamic tables may take
  static constexpr size_t STATIC_SMEM =
      CHUNK * (sizeof(int) + sizeof(int4)) + WARPS * sizeof(int) + kBatch;
  static constexpr size_t TABLE_SMEM = 48 * 1024 - STATIC_SMEM - 256;
  static_assert(THREADS <= 1024 && LANES * 8 * VECS == CS &&
                    kBatch * (kTH + kTW) <= CHUNK,
                "tile");
};
using LibTile = TileShape<128, 2, 2>;
static_assert(kTH == kTW, "one table row per tile row or column");

struct GradLevels {
  float* base[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];  // first tile of level L - 1 - k, k = 0..L
  int L;
};

// The bins of one roi that reach cell e of an axis (start, bin, g of its
// geometry row; n cells): put(o, w) for each bin o that may (w may be 0),
// in bin order; returns the first and last bin with a weight (empty when
// last < first).  A bin is tried only if its span [start + o bin, start +
// (o + 1) bin] comes within 1.5 cells of e, which every sample reaching e
// does (a clamped sample lies in [-1, n]), and within it only the slots
// whose sample can lie in that window, with a slot to spare either side
// (the others add nothing to e).  Its weight sums the slot weights of its
// taps on e in slot order, low then high neighbour.
template <class Put>
__device__ __forceinline__ int2 axis_bins(float start, float bin, float g,
                                          int e, int n, int O, int smax,
                                          Put put) {
  int first = O, last = -1;
  if (e >= n) return make_int2(first, last);
  const int ng = min((int)g, smax);
  const float ef = (float)e;
  for (int o = 0; o < O; ++o) {
    float a = start + (float)o * bin, b = start + (float)(o + 1) * bin;
    if (a > b) {
      const float s = a;
      a = b;
      b = s;
    }
    if (b < ef - 1.5f || a > ef + 1.5f) continue;
    int i0 = 0, i1 = ng - 1;
    if (fabsf(bin) > 1e-6f) {
      float u0 = ((ef - 1.5f - start) / bin - (float)o) * g - 0.5f;
      float u1 = ((ef + 1.5f - start) / bin - (float)o) * g - 0.5f;
      if (u0 > u1) {
        const float s = u0;
        u0 = u1;
        u1 = s;
      }
      i0 = max(i0, (int)floorf(fmaxf(u0, -2.f)) - 1);
      i1 = min(i1, (int)ceilf(fminf(u1, (float)ng + 1.f)) + 1);
    }
    float w = 0.f;
    for (int i = i0; i <= i1; ++i) {
      const Tap t = axis_tap(start, bin, g, n, o, i);
      if (t.lo == e) w += t.wlo;
      if (t.hi == e) w += t.whi;
    }
    put(o, w);
    if (w != 0.f) {
      if (first == O) first = o;
      last = o;
    }
  }
  return make_int2(first, last);
}

// One box cell of a roi along an axis whose box spans E > O cells: the
// first bin with a weight and the weights of `count` bins from it.  Its
// samples span at least E - 3 cells, so a bin is over (O - 2) / O of a
// cell wide, and a cell, reached by samples in a 2-cell window, takes at
// most min(O, ceil(2 O / (O - 2)) + 1) bins: 5 at O = 5, 4 from O = 6 on.
constexpr int kCellBins = 6;
struct __align__(16) AxisCell {
  int first, count;
  float w[kCellBins];
};

// The scratch of one launch: [R] boxes (int4), [R][2][lmax] AxisCell, the
// fold [R][O][O][C] fp32; R = B * P, lmax the largest level side.
struct Scratch {
  int4* boxes;
  AxisCell* cells;
  float* folded;
  int lmax;
};

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

__host__ __device__ inline size_t scratch_bytes(int64_t R, int C, int O,
                                                int lmax) {
  return align256(sizeof(int4) * R) +
         align256(sizeof(AxisCell) * R * 2 * lmax) +
         sizeof(float) * R * O * O * C;
}

Scratch scratch_of(void* base, int64_t R, int lmax) {
  unsigned char* p = static_cast<unsigned char*>(base);
  Scratch s;
  s.boxes = reinterpret_cast<int4*>(p);
  p += align256(sizeof(int4) * R);
  s.cells = reinterpret_cast<AxisCell*>(p);
  p += align256(sizeof(AxisCell) * R * 2 * lmax);
  s.folded = reinterpret_cast<float*>(p);
  s.lmax = lmax;
  return s;
}

// H and W of level `level`, the parameter arrays read with constant
// indices only (so they stay out of local memory).
__device__ __forceinline__ void level_size(const GradLevels& lv, int level,
                                           int& H, int& W) {
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l == level) {
      H = lv.H[l];
      W = lv.W[l];
    }
}

// A roi folds along an axis whose box spans 1 to O cells.
__device__ __forceinline__ bool folds(int extent, int O) {
  return extent > 0 && extent <= O;
}

// Pass 1, a block per roi r: its box (y0, y1, x0, x1), half-open, as
// roi_footprint computes it (along each axis from the low cell of the
// first live sample slot, i < g and the sample in [-1, n], to the high
// neighbour of the last; (0, 0, 0, 0) for an invalid roi or one with no
// live slot on an axis); its cells' bins along an unfolded axis; its fold
// along a folded one: folded[r, i, j, c] with i a box row (else oy) and j
// a box column (else ox), 8 channels a thread.
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_prep(GradLevels lv, const float* __restrict__ geom,
                       Scratch sc, const float* __restrict__ grad, int C,
                       int O, int smax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* ranges = reinterpret_cast<int2*>(smem_raw);           // [2][O]
  float* weights = reinterpret_cast<float*>(ranges + 2 * O);  // [2][O][O]
  __shared__ int span[4];  // first y, last y, first x, last x
  __shared__ int4 box;
  const int64_t r = blockIdx.x;
  const float* gm = geom + r * kGeom;
  int H = 0, W = 0;
  level_size(lv, (int)gm[7], H, W);
  if (threadIdx.x < 4) span[threadIdx.x] = threadIdx.x % 2 ? -1 : 0x7fffffff;
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * O * smax; k += kThreads) {
    const int axis = k / (O * smax), o = k / smax % O, i = k % smax;
    const float g = gm[4 + axis], nf = (float)(axis ? W : H);
    const float t = __fadd_rn(
        gm[axis], __fmul_rn(__fadd_rn((float)o, __fdiv_rn((float)i + 0.5f, g)),
                            gm[2 + axis]));
    if (t >= -1.f && t <= nf && (float)i < g) {
      const int lo = (int)floorf(fminf(fmaxf(t, 0.f), nf - 1.f));
      atomicMin(&span[2 * axis], lo);
      atomicMax(&span[2 * axis + 1], lo);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the high neighbour of the last live slot: min(lo + 1, n - 1)
    const int ey = min(span[1] + 1, H - 1) + 1;
    const int ex = min(span[3] + 1, W - 1) + 1;
    const bool keep = gm[6] != 0.f && span[0] < ey && span[2] < ex;
    box = keep ? make_int4(span[0], ey, span[2], ex) : make_int4(0, 0, 0, 0);
    sc.boxes[r] = box;
  }
  __syncthreads();
  const int4 bx = box;
  const int bh = bx.y - bx.x, bw = bx.w - bx.z;
  const bool fy = folds(bh, O), fx = folds(bw, O);
  // (b) the bins of each cell of an unfolded axis
  const int ty = (bh > 0 && !fy) ? bh : 0, tx = (bw > 0 && !fx) ? bw : 0;
  for (int k = threadIdx.x; k < ty + tx; k += kThreads) {
    const int axis = k >= ty, e = axis ? k - ty : k;
    AxisCell cell;
    cell.first = -1;
    cell.count = 0;
    axis_bins(gm[axis], gm[2 + axis], gm[4 + axis],
              (axis ? bx.z : bx.x) + e, axis ? W : H, O, smax,
              [&](int o, float w) {
                if (w != 0.f && cell.first < 0) cell.first = o;
                if (cell.first < 0) return;
                const int at = o - cell.first;
                if (at < kCellBins) cell.w[at] = w;
                if (w != 0.f) cell.count = at + 1;
              });
    sc.cells[(r * 2 + axis) * sc.lmax + e] = cell;
  }
  if (!(fy || fx)) return;  // no fold (an empty box folds nothing)
  // (c) the fold
  for (int k = threadIdx.x; k < 2 * O; k += kThreads) {
    const int axis = k / O, e = k % O;
    if (axis ? (fx && e < bw) : (fy && e < bh)) {
      float* wrow = weights + k * O;
      ranges[k] = axis_bins(gm[axis], gm[2 + axis], gm[4 + axis],
                            (axis ? bx.z : bx.x) + e, axis ? W : H, O, smax,
                            [&](int o, float w) { wrow[o] = w; });
    }
  }
  __syncthreads();
  const int rows = fy ? bh : O, cols = fx ? bw : O;
  const int groups = C / 8;
  const float* g_r = grad + r * O * O * C;
  float* f_r = sc.folded + r * O * O * C;
  for (int it = threadIdx.x; it < rows * cols * groups; it += kThreads) {
    const int c0 = (it % groups) * 8;
    const int i = it / groups / cols, j = it / groups % cols;
    const int2 ry = fy ? ranges[i] : make_int2(i, i);
    const int2 rx = fx ? ranges[O + j] : make_int2(j, j);
    const float* wy = weights + i * O;
    const float* wx = weights + (O + j) * O;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int oy = ry.x; oy <= ry.y; ++oy) {
      const float a = fy ? wy[oy] : 1.f;
      for (int ox = rx.x; ox <= rx.y; ++ox) {
        const float w = a * (fx ? wx[ox] : 1.f);
        const Vec8 v = load8(g_r + ((int64_t)oy * O + ox) * C + c0);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, v.v[c], acc[c]);
      }
    }
    store8(f_r + ((int64_t)i * O + j) * C + c0, acc);
  }
}

size_t prep_smem_bytes(int O) {
  return sizeof(int2) * 2 * O + sizeof(float) * 2 * O * O;
}

// A roi folds along either axis.
__device__ __forceinline__ bool folds_any(int4 box, int O) {
  return folds(box.y - box.x, O) || folds(box.w - box.z, O);
}

// One row of a tile's table for roi r (box rb): for the tile row or column
// `cell` along `axis`, the bins that reach it and their weights in wrow,
// from the roi's cells; along a folded axis its own fold row with weight
// 1.  Returns the range of bins (empty when the cell is outside).
__device__ __forceinline__ int2 table_row(const Scratch& sc, int64_t r,
                                          int4 rb, int axis, int cell,
                                          int O, float* wrow) {
  const int lo = axis ? rb.z : rb.x, ext = (axis ? rb.w : rb.y) - lo;
  const int i = cell - lo;
  if (i < 0 || i >= ext) return make_int2(O, -1);
  if (folds(ext, O)) {
    wrow[i] = 1.f;
    return make_int2(i, i);
  }
  const AxisCell c = sc.cells[(r * 2 + axis) * sc.lmax + i];
#pragma unroll
  for (int k = 0; k < kCellBins; ++k)
    if (k < c.count) wrow[c.first + k] = c.w[k];
  return make_int2(c.first, c.first + c.count - 1);
}

// Pass 2: a block per (tile, image, channel slice).  With kClocks, each
// block writes clocks[block][0..5]: its cycles in all, in the roi scan, the
// table copies, the sums and the store, and its rois
// (tune_roi_align_bwd.py).
template <class T, bool kClocks>
__global__ void __launch_bounds__(T::THREADS)
    roi_align_bwd_tiles(GradLevels lv, const float* __restrict__ geom,
                        Scratch sc, const float* __restrict__ grad, int P,
                        int C, int O, int batch,
                        long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [batch][2][kTH] bin ranges, then [batch][2][kTH][O] weights
  int2* ranges = reinterpret_cast<int2*>(smem_raw);
  float* weights = reinterpret_cast<float*>(ranges + batch * 2 * kTH);
  __shared__ int list[T::CHUNK];   // the chunk's rois meeting the tile
  __shared__ int4 boxes[T::CHUNK];  // and their boxes
  __shared__ int warp_hits[T::WARPS];
  __shared__ bool from_fold[kBatch];
  long long phase[4] = {0, 0, 0, 0}, mark = 0, rois = 0;
  auto lap = [&](int k) {
    if constexpr (kClocks) {
      if (threadIdx.x == 0) {
        const long long now = clock64();
        phase[k] += now - mark;
        mark = now;
      }
    }
  };
  if constexpr (kClocks) mark = clock64();
  // this block's level, tile and channel slice (the parameter arrays read
  // with constant indices only)
  const int t = blockIdx.x;
  int level = 0, H = 0, W = 0, tiles_x = 1, q = t;
  float* out = nullptr;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k < lv.L && t >= lv.first[k] && t < lv.first[k + 1]) {
      level = lv.L - 1 - k;
      q = t - lv.first[k];
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l == level) {
      H = lv.H[l];
      W = lv.W[l];
      tiles_x = lv.tiles_x[l];
      out = lv.base[l];
    }
  }
  const int y0 = (q / tiles_x) * kTH;
  const int x0 = (q % tiles_x) * kTW;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this thread's cell (ty, tx) and channels c0..c0 + 8 VECS - 1 (those
  // below C: C % 8 == 0)
  const int c0 = blockIdx.z * T::CS + (threadIdx.x % T::LANES) * 8 * T::VECS;
  const int ty = threadIdx.x / T::LANES / kTW;
  const int tx = threadIdx.x / T::LANES % kTW;
  const bool live = c0 < C && y0 + ty < H && x0 + tx < W;
  const int vecs = min(T::VECS, (C - c0) / 8);
  float acc[T::CHAINS][T::VECS][8];
#pragma unroll
  for (int u = 0; u < T::CHAINS; ++u)
#pragma unroll
    for (int v = 0; v < T::VECS; ++v)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[u][v][c] = 0.f;

  // the next chunk's roi (box, level), loaded a chunk ahead
  int4 nbox = make_int4(0, 0, 0, 0);
  int nlevel = -1;
  if (threadIdx.x < min(P, T::CHUNK)) {
    nbox = sc.boxes[(int64_t)b * P + threadIdx.x];
    nlevel = (int)geom[((int64_t)b * P + threadIdx.x) * kGeom + 7];
  }
  for (int base = 0; base < P; base += T::CHUNK) {
    // the rois of this chunk that reach the tile, in roi order (a box is
    // empty for an invalid roi)
    const int j = base + threadIdx.x;
    const int4 bx = nbox;
    const bool hit = nlevel == level && bx.x < y0 + kTH && bx.y > y0 &&
                     bx.z < x0 + kTW && bx.w > x0;
    if (threadIdx.x < T::CHUNK && j + T::CHUNK < P) {
      const int64_t r = (int64_t)b * P + j + T::CHUNK;
      nbox = sc.boxes[r];
      nlevel = (int)geom[r * kGeom + 7];
    } else {
      nlevel = -1;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int at = 0, count = 0;
#pragma unroll
    for (int w = 0; w < T::WARPS; ++w) {
      at += w < warp ? warp_hits[w] : 0;
      count += warp_hits[w];
    }
    if (hit) {
      at += __popc(mask & ((1u << lane) - 1u));
      list[at] = j;
      boxes[at] = bx;
    }
    __syncthreads();
    lap(0);

    for (int k0 = 0; k0 < count; k0 += batch) {
      const int nb = min(batch, count - k0);
      // the batch's tables: one thread per (roi, axis, tile row or column)
      if (threadIdx.x < nb * 2 * kTH) {
        const int e = threadIdx.x % kTH;
        const int axis = (threadIdx.x / kTH) % 2;
        const int m = threadIdx.x / (2 * kTH);
        const int4 rb = boxes[k0 + m];
        ranges[threadIdx.x] =
            table_row(sc, (int64_t)b * P + list[k0 + m], rb, axis,
                      (axis ? x0 : y0) + e, O, weights + threadIdx.x * O);
        if (axis == 0 && e == 0) from_fold[m] = folds_any(rb, O);
      }
      __syncthreads();
      lap(1);
      if (live) {
        for (int m = 0; m < nb; m += T::CHAINS) {
          // roi m + u (if any) on chain u
          const float* src[T::CHAINS];
          int2 ry[T::CHAINS], rx[T::CHAINS];
          const float *wy[T::CHAINS], *wx[T::CHAINS];
          int oy[T::CHAINS], ox[T::CHAINS];
          bool more[T::CHAINS];
#pragma unroll
          for (int u = 0; u < T::CHAINS; ++u) {
            const int mm = min(m + u, nb - 1);
            src[u] = (from_fold[mm] ? sc.folded : grad) +
                     ((int64_t)b * P + list[k0 + mm]) * O * O * C + c0;
            ry[u] = ranges[mm * 2 * kTH + ty];
            rx[u] = ranges[(mm * 2 + 1) * kTH + tx];
            wy[u] = weights + (mm * 2 * kTH + ty) * O;
            wx[u] = weights + ((mm * 2 + 1) * kTH + tx) * O;
            oy[u] = ry[u].x;
            ox[u] = rx[u].x;
            more[u] = m + u < nb && ry[u].x <= ry[u].y && rx[u].x <= rx[u].y;
          }
          bool any = false;
#pragma unroll
          for (int u = 0; u < T::CHAINS; ++u) any |= more[u];
          while (any) {
            Vec8 val[T::CHAINS][T::VECS];
            float w[T::CHAINS];
#pragma unroll
            for (int u = 0; u < T::CHAINS; ++u)
              if (more[u]) {
                w[u] = wy[u][oy[u]] * wx[u][ox[u]];
                const float* at = src[u] + ((int64_t)oy[u] * O + ox[u]) * C;
#pragma unroll
                for (int v = 0; v < T::VECS; ++v)
                  if (v < vecs) val[u][v] = load8(at + 8 * v);
              }
            any = false;
#pragma unroll
            for (int u = 0; u < T::CHAINS; ++u)
              if (more[u]) {
#pragma unroll
                for (int v = 0; v < T::VECS; ++v)
                  if (v < vecs)
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                      acc[u][v][c] = fmaf(w[u], val[u][v].v[c], acc[u][v][c]);
                if (++ox[u] > rx[u].y) {
                  ox[u] = rx[u].x;
                  more[u] = ++oy[u] <= ry[u].y;
                }
                any |= more[u];
              }
          }
        }
      }
      __syncthreads();
      lap(2);
      rois += nb;
    }
  }

  if (live) {
    float* dst = out + (((int64_t)b * H + y0 + ty) * W + x0 + tx) * C + c0;
#pragma unroll
    for (int v = 0; v < T::VECS; ++v) {
      float sum[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sum[c] = acc[0][v][c];
#pragma unroll
        for (int u = 1; u < T::CHAINS; ++u) sum[c] += acc[u][v][c];
      }
      if (v < vecs) store8(dst + 8 * v, sum);
    }
  }
  lap(3);
  if constexpr (kClocks) {
    if (threadIdx.x == 0) {
      long long* at = clocks + (((int64_t)blockIdx.z * gridDim.y +
                                 blockIdx.y) * gridDim.x + blockIdx.x) * 6;
      at[0] = phase[0] + phase[1] + phase[2] + phase[3];
      for (int k = 0; k < 4; ++k) at[1 + k] = phase[k];
      at[5] = rois;
    }
  }
}

// The tile pass's table batch at O x O bins: kBatch rois, or as many as
// shape T's dynamic shared memory holds (0: not one).
template <class T>
int table_batch(int O) {
  const size_t per_roi = (sizeof(int2) + sizeof(float) * O) * 2 * kTH;
  return (int)min((size_t)kBatch, T::TABLE_SMEM / per_roi);
}

template <class T>
size_t bwd_smem_bytes(int O) {
  return (sizeof(int2) + sizeof(float) * O) * 2 * kTH * table_batch<T>(O);
}

int largest_side(const int* h, const int* w, int L) {
  int m = 1;
  for (int l = 0; l < L; ++l) m = max(m, max(h[l], w[l]));
  return m;
}


// roi_align_bwd's conditions on its arguments.
bool bwd_args_ok(const GradLevels& lv, int B, int P, int C, int O,
                 int smax) {
  return lv.L >= 1 && lv.L <= kMaxLevels && C > 0 && C % 8 == 0 && O >= 1 &&
         smax >= 1 && table_batch<LibTile>(O) >= 1 &&
         prep_smem_bytes(O) <= 48 * 1024 && B >= 0 && B <= 65535 && P >= 0 &&
         (int64_t)B * P <= 0x7fffffff;
}

// Both passes on level buffers lv, the tile pass of shape T (with each
// block's clocks where kClocks).  The arguments are roi_align_bwd's,
// checked there.
template <class T, bool kClocks>
cudaError_t launch_bwd(GradLevels lv, const void* geom, const void* g,
                       void* scratch, int B, int P, int C, int O, int smax,
                       long long* clocks, cudaStream_t s) {
  int64_t tiles = 0;
  for (int k = 0; k < lv.L; ++k) {
    const int l = lv.L - 1 - k;
    if (lv.H[l] < 0 || lv.W[l] < 0) return cudaErrorInvalidValue;
    lv.tiles_x[l] = (lv.W[l] + kTW - 1) / kTW;
    lv.first[k] = (int)tiles;
    tiles += (int64_t)((lv.H[l] + kTH - 1) / kTH) * lv.tiles_x[l];
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  }
  for (int k = lv.L; k <= kMaxLevels; ++k) lv.first[k] = (int)tiles;
  if (table_batch<T>(O) < 1) return cudaErrorInvalidValue;
  const float* gm = static_cast<const float*>(geom);
  const float* gr = static_cast<const float*>(g);
  const Scratch sc = scratch_of(scratch, (int64_t)B * P,
                                largest_side(lv.H, lv.W, lv.L));
  if ((int64_t)B * P > 0)
    roi_align_bwd_prep<<<B * P, kThreads, prep_smem_bytes(O), s>>>(
        lv, gm, sc, gr, C, O, smax);
  const dim3 grid((unsigned)tiles, (unsigned)B,
                  (unsigned)((C + T::CS - 1) / T::CS));
  if (tiles > 0 && B > 0)
    roi_align_bwd_tiles<T, kClocks>
        <<<grid, T::THREADS, bwd_smem_bytes<T>(O), s>>>(
            lv, gm, sc, gr, P, C, O, table_batch<T>(O), clocks);
  return cudaGetLastError();
}

}  // namespace

// feats: L (1..4) levels [B, H_l, W_l, C] NHWC contiguous, 16-byte aligned;
// geom [B * P, 8] fp32; out [B, P, O, O, C] in the features' dtype: bf16
// if bf16 is 1, fp32 if it is 0.  C % 8 == 0, O >= 1, 1 <= smax and the
// roi's tables (fwd_smem_bytes: 64 O smax + 8 O bytes) within a block's
// shared memory, else cudaErrorInvalidValue.
extern "C" int roi_align_fwd(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int L,
                             const void* geom, void* out, int B, int P,
                             int C, int O, int smax, int bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || C <= 0 || C % 8 || O < 1 || smax < 1 ||
      fwd_smem_bytes(O, smax) > kMaxDynamicSmem || B < 0 || P < 0 ||
      (int64_t)B * P > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const float* g = static_cast<const float*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * P;
  return (int)(bf16 ? launch_fwd<__nv_bfloat16>(lv, g, out, R, P, C, O,
                                                smax, s)
                    : launch_fwd<float>(lv, g, out, R, P, C, O, smax, s));
}

// Bytes of the backward's scratch buffer at B x P rois, C channels, O x O
// bins and L levels of sides (h_l, w_l): the rois' boxes first ([B * P]
// int4, (y0, y1, x0, x1) as roi_footprint computes them), then their
// cells' bins and folds.  -1 for arguments roi_align_bwd refuses.
extern "C" long long roi_align_bwd_scratch_bytes(int B, int P, int C, int O,
                                                 int h0, int w0, int h1,
                                                 int w1, int h2, int w2,
                                                 int h3, int w3, int L) {
  if (L < 1 || L > kMaxLevels || B < 0 || P < 0 || C <= 0 || O < 1)
    return -1;
  const int h[kMaxLevels] = {h0, h1, h2, h3}, w[kMaxLevels] = {w0, w1, w2, w3};
  return (long long)scratch_bytes((int64_t)B * P, C, O, largest_side(h, w, L));
}

// The backward.  grad0..grad3: L (1..4) fp32 gradient buffers [B, H_l, W_l,
// C], NHWC contiguous, 16-byte aligned; the kernels write every cell of
// them (the caller need not clear them).  geom [B * P, 8] fp32, the
// forward's; g the fp32 cotangent [B, P, O, O, C], contiguous; scratch of
// roi_align_bwd_scratch_bytes bytes, 256-byte aligned, uncleared, which
// the kernels fill: it starts with the rois' boxes.  C % 8 == 0, 1 <= O
// <= 77 (the fold's bin tables within 48 KB of shared memory), 1 <= smax
// and B <= 65535, else cudaErrorInvalidValue.
extern "C" int roi_align_bwd(void* grad0, void* grad1, void* grad2,
                             void* grad3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int L,
                             const void* geom, const void* g, void* scratch,
                             int B, int P, int C, int O, int smax,
                             void* stream) {
  const GradLevels lv{{static_cast<float*>(grad0), static_cast<float*>(grad1),
                       static_cast<float*>(grad2), static_cast<float*>(grad3)},
                      {h0, h1, h2, h3},
                      {w0, w1, w2, w3},
                      {},
                      {},
                      L};
  if (!bwd_args_ok(lv, B, P, C, O, smax)) return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<LibTile, false>(lv, geom, g, scratch, B, P, C, O,
                                         smax, nullptr,
                                         static_cast<cudaStream_t>(stream));
}
