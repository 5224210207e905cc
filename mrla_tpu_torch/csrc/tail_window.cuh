// The MRLA-light tail as a sliding 3x3 window in registers, shared by the
// block tail from z (mrla_block_tail.cu) and the epilogue (mrla_epilogue.cu):
//
//     y = x + (dwconv3x3(x) * gate + lam * id) * bn_scale + bn_bias
//
// with x = relu(z + id) in fp32 for the block tail (FromZ) and x = out for
// the epilogue (FromOut); the [B, C] gate is computed beforehand.
//
// Bound on an H100: memory.  Per element each tail reads two bf16 maps and
// writes y (6 bytes) for about 24 fp32 operations.
//
// Design: a thread owns 8 channels along a segment of one row of one image
// (a whole row up to kMaxSegment pixels).  It keeps x of the window's three
// columns (rows h - 1, h, h + 1) in registers, each column formed once, and
// per pixel loads only one new column: FromZ 3 rows x (z, id), 6 copies of
// 16 bytes; FromOut 3 rows of out and the centre row's id, 4 copies.  Those
// go by cp.async into the thread's own ring of STAGES columns in shared
// memory, STAGES - 1 columns ahead of the one in use, so the loads in flight
// cost no registers.  The 3x3 weights, lam, scale, bias and the image's gate
// stay in registers for the whole segment, the pixel's identity comes from
// the window's centre and (b, h, w) are carried, not divided out.  The
// C / 8 threads of a pixel sit side by side (a warp reads 512 contiguous
// bytes at C = 256), so device memory sees each map once and L2 each
// element of the row maps three times (a row's, the row above's and the
// row below's window).  The taps are summed with fmaf in tail_taps8's order
// (row-major, taps outside the image skipped) and finished by
// mrla_tail_combine: y is bit for bit mrla_tail_y8's (FromOut) and
// mrla_block_tail_y8's (FromZ).  Rows above and below come from the pixel's
// own image only: the feed zero-fills them at h = 0 and h = H - 1 and
// window_y skips them.
//
// The window holds each column as fp32 (24 registers) or, where x is a bf16
// value (FromOut), as the packed bf16 pieces (12 registers), widened at
// each tap: both exact, the choice a matter of registers against
// instructions (tune_epilogue.py measures it).
#pragma once

#include <type_traits>

#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

// What a window column holds: kPieces 16-byte pieces a thread, the rows'
// x pieces at 0..2 (z or out of rows h - 1, h, h + 1) and id pieces at
// id_piece(r) (-1: none).
struct FromZ {  // the block tail: z and id of the three rows
  static constexpr int kPieces = 6;
  __host__ __device__ static constexpr int id_piece(int r) { return 3 + r; }
};
struct FromOut {  // the epilogue: out of the three rows, id of the centre
  static constexpr int kPieces = 4;
  __host__ __device__ static constexpr int id_piece(int r) {
    return r == 1 ? 3 : -1;
  }
};

// x = relu(z + id) in fp32 of one 16-byte piece of z and of id
__device__ __forceinline__ void form_x(uint4 z, uint4 id, float x[8]) {
  float zf[8], idf[8];
  bf16x8_to_float(z, zf);
  bf16x8_to_float(id, idf);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = fmaxf(zf[i] + idf[i], 0.f);
}

// One window column: x of rows h - 1, h, h + 1, as fp32 or packed bf16.
template <bool kPacked>
struct WinCol;
template <>
struct WinCol<false> {
  float x[3][8];
  __device__ __forceinline__ void row(int r, float (&f)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = x[r][i];
  }
};
template <>
struct WinCol<true> {
  uint4 x[3];
  __device__ __forceinline__ void row(int r, float (&f)[8]) const {
    bf16x8_to_float(x[r], f);
  }
};

// y of pixel p from its window: L, M, R the columns p - 1, p, p + 1, id
// the pixel's identity.
template <bool kPacked>
__device__ __forceinline__ uint4 window_y(
    const WinCol<kPacked>& L, const WinCol<kPacked>& M,
    const WinCol<kPacked>& R, uint4 id, const float (&wv)[9][8],
    const float* lam, const float* sc, const float* bi, const float* gate,
    bool top, bool bottom, bool left, bool right) {
  float acc[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if ((r == 0 && !top) || (r == 2 && !bottom)) continue;
    if (left) {
      L.row(r, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(v[i], wv[r * 3][i], acc[i]);
    }
    M.row(r, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(v[i], wv[r * 3 + 1][i], acc[i]);
    if (right) {
      R.row(r, v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(v[i], wv[r * 3 + 2][i], acc[i]);
    }
  }
  float idv[8], out[8];
  bf16x8_to_float(id, idv);
  M.row(1, v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = mrla_tail_combine(v[i], acc[i], gate[i], lam[i], idv[i], sc[i],
                               bi[i]);
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
// and their left and right neighbours), each Kind::kPieces pieces.  The
// feed copies them one after another into the thread's ring by cp.async, a
// commit group each (an empty group for a column outside the image or past
// w1).
template <class Kind, int NT, int STAGES>
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
        uint4* dst = ring + (stage * Kind::kPieces * NT + threadIdx.x);
        cp_async16(dst + r * NT, ok ? a.out + at : a.out, ok);
        if (Kind::id_piece(r) >= 0)
          cp_async16(dst + Kind::id_piece(r) * NT, ok ? a.id + at : a.id, ok);
      }
    }
    cp_async_commit();
    ++col;
    if (++stage == STAGES) stage = 0;
  }
};

// The window's column from ring stage `stage`: x and the centre row's id.
template <class Kind, int NT, bool kPacked>
__device__ __forceinline__ void read_column(const uint4* ring, int stage,
                                            WinCol<kPacked>& col, uint4& id) {
  const uint4* src = ring + (stage * Kind::kPieces * NT + threadIdx.x);
  id = src[Kind::id_piece(1) * NT];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if constexpr (std::is_same<Kind, FromZ>::value) {
      static_assert(!kPacked, "relu(z + id) is fp32: no packed window");
      form_x(src[r * NT], src[Kind::id_piece(r) * NT], col.x[r]);
    } else if constexpr (kPacked) {
      col.x[r] = src[r * NT];
    } else {
      bf16x8_to_float(src[r * NT], col.x[r]);
    }
  }
}

// A thread per 8 channels of a segment of seg pixels of a row (segs
// segments a row): n_items = B x H x segs x C / 8.  Its ring holds STAGES
// columns of the feed: before a column is read, the STAGES - 1 after it
// are in flight.
template <class Kind, bool kPacked, int NT, int STAGES>
__global__ void __launch_bounds__(NT)
    tail_window_kernel(TailArgs a, __nv_bfloat16* __restrict__ y,
                       int64_t n_items, int seg, int segs) {
  static_assert(STAGES >= 2, "a ring of two columns at least");
  // [STAGES][Kind::kPieces][NT] 16-byte pieces
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

  ColumnFeed<Kind, NT, STAGES> feed{
      a, ring, (row - 1) * a.W * (int64_t)a.C + c0, top, bottom, w0 - 1, w1};
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) feed.issue();
  int stage = 0;  // the next column to read
  // the window's three columns by slot, and the centre row's identity
  WinCol<kPacked> win[3];
  uint4 idc[3];
  auto next = [&](WinCol<kPacked>& col, uint4& id) {
    cp_async_wait<STAGES - 2>();
    read_column<Kind, NT>(ring, stage, col, id);
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

template <class Kind>
constexpr size_t ring_bytes(int nt, int stages) {
  return sizeof(uint4) * Kind::kPieces * (size_t)nt * stages;
}

// Segment length, segments a row, items and blocks at [B, H, W, C] for
// segments of at most max_seg pixels and nt threads a block: a row is one
// segment up to max_seg pixels and is cut into equal segments beyond.
struct Segments {
  int seg, segs;
  int64_t items, blocks;
};

inline Segments segments_of(int B, int H, int W, int C, int max_seg,
                            int nt) {
  Segments g;
  g.segs = (W + max_seg - 1) / max_seg;
  g.seg = g.segs ? (W + g.segs - 1) / g.segs : 0;
  g.items = (int64_t)B * H * g.segs * (C / 8);
  g.blocks = (g.items + nt - 1) / nt;
  return g;
}

// The entry points' shared body: y at [B, H, W, C] by `kernel` (threads nt,
// dynamic shared memory smem) over segments of at most max_seg pixels.
template <class K>
cudaError_t launch_window(K kernel, int nt, size_t smem, int max_seg,
                          const TailArgs& a, void* y, int B,
                          cudaStream_t stream) {
  const Segments g = segments_of(B, a.H, a.W, a.C, max_seg, nt);
  if (g.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (g.blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)g.blocks, nt, smem, stream>>>(
      a, static_cast<__nv_bfloat16*>(y), g.items, g.seg, g.segs);
  return cudaGetLastError();
}

// What a launch is: out[0] the segment length (pixels a thread walks),
// out[1] threads a block, out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] blocks, out[4]
// columns in a thread's ring.
template <class K>
cudaError_t describe_window(K kernel, int nt, size_t smem, int stages,
                            int max_seg, int B, int H, int W, int C,
                            int* out) {
  const Segments g = segments_of(B, H, W, C, max_seg, nt);
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  out[0] = g.seg;
  out[1] = nt;
  out[2] = per_sm;
  out[3] = (int)g.blocks;
  out[4] = stages;
  return err;
}

inline TailArgs tail_args(const void* x, const void* id, const void* gate,
                          const void* wv, const void* lam, const void* scale,
                          const void* bias, int H, int W, int C) {
  return TailArgs{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(id),
                  static_cast<const float*>(gate),
                  static_cast<const float*>(wv),
                  static_cast<const float*>(lam),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(bias),
                  H, W, C};
}

}  // namespace
