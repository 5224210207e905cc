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
// Design: a sliding 3x3 window in registers.  A thread owns 8 channels
// along a segment of one row of one image (a whole row at the route's
// shapes).
// It keeps x of the window's three columns (rows h - 1, h, h + 1) as fp32,
// each x formed once from one load of z and id, and per pixel loads only
// one new column: 3 pixels x (z, id), 6 copies of 16 bytes.  Those go by
// cp.async into the thread's own ring of STAGES columns in shared memory,
// STAGES - 1 columns ahead of the one in use, so the loads in flight cost
// no registers (the window and the constants take nearly all of them).
// The 3x3 weights, lam, scale, bias and the image's gate stay in registers
// for the whole segment, the pixel's identity comes from the window's
// centre and (b, h, w) are carried, not divided out.  The C / 8 threads of
// a pixel sit side by side (a warp reads 512 contiguous bytes at C = 256),
// so device memory sees z and id once and L2 each element three times (a
// row's, the row above's and the row below's window), where a thread per
// 8-channel vector read every neighbour and the weights again.  The taps
// are summed with fmaf in tail_taps8's order (row-major, taps outside the
// image skipped) and finished by mrla_tail_combine: the same y, bit for
// bit, as mrla_block_tail_y8.
#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

// x = relu(z + id) in fp32 of one 16-byte piece of z and of id
__device__ __forceinline__ void form_x(uint4 z, uint4 id, float x[8]) {
  float zf[8], idf[8];
  bf16x8_to_float(z, zf);
  bf16x8_to_float(id, idf);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = fmaxf(zf[i] + idf[i], 0.f);
}

// y of pixel p from its window: L, M, R the columns p - 1, p, p + 1 (rows
// h - 1, h, h + 1), id the pixel's identity.
__device__ __forceinline__ uint4 window_y(
    const float (&L)[3][8], const float (&M)[3][8], const float (&R)[3][8],
    uint4 id, const float (&wv)[9][8], const float* lam, const float* sc,
    const float* bi, const float* gate, bool top, bool bottom, bool left,
    bool right) {
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if ((r == 0 && !top) || (r == 2 && !bottom)) continue;
    if (left) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(L[r][i], wv[r * 3][i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = fmaf(M[r][i], wv[r * 3 + 1][i], acc[i]);
    if (right) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(R[r][i], wv[r * 3 + 2][i], acc[i]);
    }
  }
  float idv[8], out[8];
  bf16x8_to_float(id, idv);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = mrla_tail_combine(M[1][i], acc[i], gate[i], lam[i], idv[i],
                               sc[i], bi[i]);
  return pack_bf16x8(out);
}

__device__ __forceinline__ void load_constants(const TailArgs& a, int c0,
                                               int64_t img,
                                               float (&wv)[9][8], float* lam,
                                               float* sc, float* bi,
                                               float* gate) {
#pragma unroll
  for (int t = 0; t < 9; ++t) load_f8(a.wv + t * a.C + c0, wv[t]);
  load_f8(a.lam + c0, lam);
  load_f8(a.scale + c0, sc);
  load_f8(a.bias + c0, bi);
  load_f8(a.gate + img * a.C + c0, gate);
}

// A thread's window columns, w0 - 1 .. w1 (its segment's pixels w0 .. w1 - 1
// and their left and right neighbours), each as 3 pixels (rows h - 1, h,
// h + 1) x (z, id).  The feed copies them one after another into the
// thread's ring by cp.async, a commit group each (an empty group for a
// column outside the image or past w1).
template <int NT, int STAGES>
struct ColumnFeed {
  const TailArgs& a;
  uint4* ring;
  int64_t top_row;  // (image, h - 1, 0, c0)
  bool top, bottom;
  int col, end;   // the next column to copy; the last one
  int stage = 0;  // and its ring stage
  __device__ __forceinline__ void issue() {
    if (col >= 0 && col < a.W && col <= end) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const bool ok = (r != 0 || top) && (r != 2 || bottom);
        const int64_t at = top_row + ((int64_t)r * a.W + col) * a.C;
        uint4* dst = ring + ((stage * 6 + r) * NT + threadIdx.x);
        cp_async16(dst, ok ? a.out + at : a.out, ok);
        cp_async16(dst + 3 * NT, ok ? a.id + at : a.id, ok);
      }
    }
    cp_async_commit();
    ++col;
    if (++stage == STAGES) stage = 0;
  }
};

// The window's column from ring stage `stage`: x and the centre row's id.
template <int NT>
__device__ __forceinline__ void read_column(const uint4* ring, int stage,
                                            float (&x)[3][8], uint4& id) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint4* src = ring + ((stage * 6 + r) * NT + threadIdx.x);
    const uint4 idr = src[3 * NT];
    form_x(src[0], idr, x[r]);
    if (r == 1) id = idr;
  }
}

// A thread per 8 channels of a segment of seg pixels of a row (segs
// segments a row): n_items = B x H x segs x C / 8.  Its ring holds STAGES
// columns of the feed: before a column is read, the STAGES - 1 after it
// are in flight.
template <int NT, int STAGES>
__global__ void __launch_bounds__(NT)
    mrla_block_tail_kernel(TailArgs a, __nv_bfloat16* __restrict__ y,
                           int64_t n_items, int seg, int segs) {
  static_assert(STAGES >= 2, "a ring of two columns at least");
  // [STAGES][z rows 0..2, id rows 0..2][NT] 16-byte pieces
  extern __shared__ uint4 ring[];
  const int64_t item = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (item >= n_items) return;
  const int vecs = a.C >> 3;
  const int64_t s = item / vecs;
  const int c0 = (int)(item - s * vecs) * 8;
  const int64_t row = s / segs;  // image * H + h
  const int64_t img = row / a.H;
  const int h = (int)(row - img * a.H);
  const int w0 = (int)(s - row * segs) * seg, w1 = min(w0 + seg, a.W);
  const bool top = h > 0, bottom = h + 1 < a.H;
  float wv[9][8], lam[8], sc[8], bi[8], gate[8];
  load_constants(a, c0, img, wv, lam, sc, bi, gate);

  ColumnFeed<NT, STAGES> feed{
      a, ring, (row - 1) * a.W * (int64_t)a.C + c0, top, bottom, w0 - 1, w1};
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) feed.issue();
  int stage = 0;  // the next column to read
  // the window's three columns by slot, and the centre row's identity
  float win[3][3][8];
  uint4 idc[3];
  auto next = [&](float(&x)[3][8], uint4& id) {
    cp_async_wait<STAGES - 2>();
    read_column<NT>(ring, stage, x, id);
    if (++stage == STAGES) stage = 0;
    feed.issue();
  };
  next(win[0], idc[0]);  // column w0 - 1
  next(win[1], idc[1]);  // column w0
  __nv_bfloat16* yrow = y + row * a.W * (int64_t)a.C + c0;
  for (int w = w0; w < w1; w += 3) {
    // unrolled over three pixels: pixel w + k has its left column in slot
    // k % 3, its own in (k + 1) % 3 and its right in (k + 2) % 3
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = w + k;
      if (p >= w1) break;
      next(win[(k + 2) % 3], idc[(k + 2) % 3]);
      *reinterpret_cast<uint4*>(yrow + (int64_t)p * a.C) =
          window_y(win[k % 3], win[(k + 1) % 3], win[(k + 2) % 3],
                   idc[(k + 1) % 3], wv, lam, sc, bi, gate, top, bottom,
                   p > 0, p + 1 < a.W);
    }
  }
  cp_async_wait<0>();
}

constexpr size_t ring_bytes(int nt, int stages) {
  return sizeof(uint4) * 6 * (size_t)nt * stages;
}

// The launch, chosen by measurement (tune_block_tail.py): 64 threads a
// block; rings of 8 columns (48 KB of shared memory) on rows of 28 pixels
// or more, of 4 on shorter rows, whose few columns a deeper ring would
// only fill at the start.  A row is one segment up to kMaxSegment pixels
// and is cut into equal segments beyond.
constexpr int kThreads = 64;
constexpr int kMaxSegment = 64;

template <class F>
cudaError_t with_ring(int W, F&& f) {
  if (W >= 28) return f(mrla_block_tail_kernel<kThreads, 8>, 8);
  return f(mrla_block_tail_kernel<kThreads, 4>, 4);
}

// Segment length, segments a row, items and blocks at [B, H, W, C].
struct Segments {
  int seg, segs;
  int64_t items, blocks;
};

Segments segments_of(int B, int H, int W, int C) {
  Segments g;
  g.segs = (W + kMaxSegment - 1) / kMaxSegment;
  g.seg = g.segs ? (W + g.segs - 1) / g.segs : 0;
  g.items = (int64_t)B * H * g.segs * (C / 8);
  g.blocks = (g.items + kThreads - 1) / kThreads;
  return g;
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
  TailArgs a{static_cast<const __nv_bfloat16*>(z),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate),
             static_cast<const float*>(wv),
             static_cast<const float*>(lam),
             static_cast<const float*>(scale),
             static_cast<const float*>(bias),
             H, W, C};
  const Segments g = segments_of(B, H, W, C);
  if (g.blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (g.blocks == 0) return (int)cudaSuccess;
  return (int)with_ring(W, [&](auto kernel, int stages) {
    kernel<<<(unsigned)g.blocks, kThreads, ring_bytes(kThreads, stages),
             static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<__nv_bfloat16*>(y), g.items, g.seg, g.segs);
    return cudaGetLastError();
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
  const Segments g = segments_of(B, H, W, C);
  return (int)with_ring(W, [&](auto kernel, int stages) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, ring_bytes(kThreads, stages));
    out[0] = g.seg;
    out[1] = kThreads;
    out[2] = per_sm;
    out[3] = (int)g.blocks;
    out[4] = stages;
    return err;
  });
}
