// The MRLA-light block tail fused with the next block's 1x1 conv, shared by
// the mega-tail (mrla_megatail.cu) and the row tail (mrla_rowtail.cu), which
// differ only in how y is summed (YOp) and in the tiles they pick:
//
//     y  = YOp(out, id, ...)               (bf16, written out)
//     x1 = relu(bf16(y) @ W1 + b1)         (the next block's conv1, BN folded)
//
// so y never makes a second trip through device memory to feed the next
// conv.  A block of 256 threads owns BM pixels x all C channels:
//   0. before anything else it starts copying the first S - 1 K chunks of
//      W1 (given as the conv weight [C1, C]) into a ring of S = kX1Stages
//      = 3 stages in shared memory with cp.async (16 bytes a copy, past L1 and the
//      registers), so W1's first chunks arrive while the block computes y;
//   1. y for the tile, written out and kept in shared memory as bf16: the
//      product reads exactly the rounded y that was written.  The tile is
//      stored as C / 64 slices of [BM, 64] channels, 128 bytes a row, the
//      16-byte piece q of row m at q ^ (m & 7): the 128-byte swizzle that
//      wgmma reads and that ldmatrix reads without bank conflicts.  Where
//      C / 8 divides the block (C = 64 .. 2048) the y phase is
//      tail_x1_y_rows: each thread owns 8 channels for a run of pixels,
//      keeps their constants (and, in the 2-pixel walk, their 3x3 weights)
//      in registers, issues every tap's load of 1 or 2 pixels before any
//      sum and carries the pixel's (image, h, w) along instead of dividing
//      it out; elsewhere it takes 8-channel vectors pixel after pixel, as
//      the epilogue does.  In a block that also holds a product tile the y
//      phase is the larger part of the time, and its speed is the loads a
//      thread has in flight: walked by vectors it alone takes 1.3x (C =
//      256) to 1.9x (C = 512) and 3x (C = 1024, 2048) the time of the
//      standalone y kernel, walked by rows 1.0 to 1.1x (tune_tail_x1.py);
//   2. x1 = ys @ W1^T in chunks of CN columns.  The (column chunk, K chunk)
//      steps run as one sequence through the ring: at each step a thread
//      waits for its own copies of the step's chunk
//      (cp.async.wait_group S - 2), one barrier makes everyone's visible and
//      frees the stage read a step earlier, which at once takes the chunk
//      S - 1 steps ahead.  64-pixel tiles use wgmma m64nNk16 (each
//      warpgroup N = CN / 2 columns, A the y tile's slice, B the ring
//      stage, both through wgmma_desc); smaller tiles use mma.sync m16n8k16
//      with ldmatrix.x4 fragments (A from the y tile, B two n8 tiles at a
//      time from the ring; 32-deep K chunks are 64-byte rows swizzled by
//      (row / 2) & 3).  bf16 in, fp32 accumulate, no library: no cuBLAS, no
//      CUTLASS device GEMM;
//   3. bias + ReLU in registers, x1 stored as bf16 pairs.
// Shared memory is BM x C + 3 x CN x KC bf16, + 1 KB to align a wgmma tile
// (X1Tile::smem_bytes; the wrappers' tail_x1_smem_bytes).
#pragma once

#include <stdint.h>

#include <mutex>

#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

constexpr int kX1Threads = 256;      // 8 warps, 2 warpgroups
constexpr int kX1Stages = 3;         // W1 chunks in the ring (RING_STAGES)
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// A tile of tail_x1_kernel: BM = 16 WM MT pixels, CN = 8 (8 / WM) NT x1
// columns a chunk (mma.sync: WM warps along the pixels, each MT m16 tiles,
// 8 / WM along the columns, each NT n8 tiles; wgmma with WG = 1: BM = 64,
// two warpgroups of CN / 2 columns), K chunks KC deep in the ring,
// __launch_bounds__ asking MINB blocks an SM, the y phase walking YU
// pixels at a time (0: by 8-channel vectors), with its 3x3 weights in
// registers where YU = 2.
template <int WM_, int MT_, int NT_, int KC_, int MINB_, int YU_, int WG_>
struct X1Tile {
  static constexpr int WM = WM_, MT = MT_, NT = NT_, KC = KC_;
  static constexpr int MINB = MINB_, YU = YU_, WG = WG_;
  static constexpr int WN = 8 / WM;
  static constexpr int BM = 16 * WM * MT;  // pixels a block
  static constexpr int CN = 8 * WN * NT;   // x1 columns a chunk
  static constexpr int kRowBytes = 2 * KC;
  static constexpr int kStageBytes = CN * kRowBytes;
  static_assert(WM * WN == 8 && NT % 2 == 0 && (KC == 32 || KC == 64) &&
                    YU >= 0 && YU <= 2, "tile");
  static_assert(CN * (KC / 8) % kX1Threads == 0, "ring copies");
  static_assert(!WG || (BM == 64 && KC == 64 && (CN == 64 || CN == 128)),
                "wgmma tile");
  // y tile + ring, bytes (+ room to align both to 1024 bytes for wgmma)
  static constexpr size_t smem_bytes(int C) {
    return (size_t)BM * C * 2 + (size_t)kX1Stages * kStageBytes +
           (WG ? 1024 : 0);
  }
};

// The 16-byte piece q of ring row n: KC = 64 rows are 128 bytes, KC = 32
// rows 64; either way the 8 rows an ldmatrix reads fall in 8 bank groups.
template <int KC>
__device__ __forceinline__ int ring_piece(int n, int q) {
  return KC == 64 ? q ^ (n & 7) : q ^ ((n >> 1) & 3);
}

// d[64 x 32] += A[64 x 16] @ B[32 x 16]^T, both from shared memory,
// asynchronously: this thread's 16 values of the warpgroup's tile (rows
// 16 * warp + lane / 4 and + 8, columns 8 j + 2 * (lane % 4) and + 1).
__device__ __forceinline__ void wgmma_64x32x16(float d[16], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] @ B[64 x 16]^T, as wgmma_64x32x16.
__device__ __forceinline__ void wgmma_64x64x16(float d[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// 8 channels of y tile row m at channel c0: the 128-byte swizzle.
__device__ __forceinline__ uint4* tile_piece(unsigned char* ys, int BM, int m,
                                             int c0) {
  return reinterpret_cast<uint4*>(ys + (c0 >> 6) * (BM * 128) + m * 128 +
                                  ((((c0 >> 3) & 7) ^ (m & 7)) << 4));
}

// The y phase by 8-channel vectors, pixel after pixel (YOp::y8); rows past
// the end of the map are zero in shared memory and never stored.
template <class YOp>
__device__ __forceinline__ void tail_x1_y_vectors(
    const TailArgs& a, int64_t p0, int BM, int64_t P,
    __nv_bfloat16* __restrict__ y, unsigned char* ys) {
  const int C = a.C;
  const int vecs = C / 8;
  for (int i = threadIdx.x; i < BM * vecs; i += kX1Threads) {
    const int m = i / vecs;
    const int c0 = (i - m * vecs) * 8;
    const int64_t p = p0 + m;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) {
      r = YOp::y8(a, p, c0);
      *reinterpret_cast<uint4*>(y + p * C + c0) = r;
    }
    *tile_piece(ys, BM, m, c0) = r;
  }
}

// A pixel of the tile as tail_x1_y_rows walks it: its row in the tile, its
// index in the map (32 bits: the kernel takes this walk below 2^31 pixels)
// and (image, h, w).
struct TilePixel {
  int m, p, img, h, w;
  // on by n pixels, carrying w into h and h into the image
  __device__ __forceinline__ void step(int n, int H, int W) {
    m += n;
    p += n;
    w += n;
    while (w >= W) {
      w -= W;
      if (++h == H) {
        h = 0;
        ++img;
      }
    }
  }
};

// The y phase with 8 channels a thread (C / 8 divides the block): thread t
// owns channels (t % (C / 8)) 8.. of every (256 / (C / 8))-th pixel of the
// tile, walks them U at a time with all their taps' loads (and the
// identity's) issued before any sum, a tap outside the image loading
// nothing and adding 0, and keeps its channels' constants (YOp::consts)
// and the image's gate in registers; with HOLD = 2 the 3x3 weights too.
// The sums are taken in the order of mrla_tail.cuh's tail_taps8 and
// finished by YOp::combine, so y is the one YOp::y8 gives.
template <class YOp, int U, int HOLD>
__device__ __forceinline__ void tail_x1_y_rows(
    const TailArgs& a, int64_t p0, int BM, int64_t P,
    __nv_bfloat16* __restrict__ y, unsigned char* ys) {
  const int C = a.C, H = a.H, W = a.W;
  const int groups = C >> 3;
  const int lanes = kX1Threads / groups;
  const int c0 = (threadIdx.x % groups) * 8;
  const int last = (int)(P - 1 - p0);  // the tile's last row in the map
  float wv[HOLD == 2 ? 9 : 1][8], k1[8], k2[8], k3[8], gate[8];
  if constexpr (HOLD == 2) {
#pragma unroll
    for (int t = 0; t < 9; ++t) load_f8(a.wv + t * C + c0, wv[t]);
  }
  YOp::consts(a, c0, k1, k2, k3);
  int gimg = -1;
  TilePixel px;
  px.m = threadIdx.x / groups;
  px.p = (int)p0 + px.m;
  px.w = px.p % W;
  px.h = (px.p / W) % H;
  px.img = px.p / W / H;
  for (; px.m < BM; px.step(lanes * U, H, W)) {
    TilePixel pu[U];
    uint4 x[U][9], idv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pu[u] = px;
      if (u) {
        pu[u] = pu[u - 1];
        pu[u].step(lanes, H, W);
      }
      const bool live = pu[u].m < BM && pu[u].m <= last;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int hh = pu[u].h + t / 3 - 1;
        const int ww = pu[u].w + t % 3 - 1;
        const bool ok = live && (unsigned)hh < (unsigned)H &&
                        (unsigned)ww < (unsigned)W;
        const int64_t at =
            (int64_t)((pu[u].img * H + hh) * W + ww) * C + c0;
        x[u][t] = ok ? __ldg(reinterpret_cast<const uint4*>(a.out + at))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
      idv[u] = live ? __ldg(reinterpret_cast<const uint4*>(
                          a.id + (int64_t)pu[u].p * C + c0))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (pu[u].m >= BM) break;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (pu[u].m <= last) {
        if (pu[u].img != gimg) {
          gimg = pu[u].img;
          load_f8(a.gate + (int64_t)gimg * C + c0, gate);
        }
        float acc[8], o[8], v[8], t8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          bf16x8_to_float(x[u][t], v);
          const float* wt = t8;
          if constexpr (HOLD == 2)
            wt = wv[t];
          else
            load_f8(a.wv + t * C + c0, t8);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(v[i], wt[i], acc[i]);
          if (t == 4) {
#pragma unroll
            for (int i = 0; i < 8; ++i) o[i] = v[i];
          }
        }
        bf16x8_to_float(idv[u], v);
        float yv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          yv[i] = YOp::combine(o[i], acc[i], gate[i], v[i], k1[i], k2[i],
                               k3[i]);
        r = pack_bf16x8(yv);
        *reinterpret_cast<uint4*>(y + (int64_t)pu[u].p * C + c0) = r;
      }
      *tile_piece(ys, BM, pu[u].m, c0) = r;
    }
  }
}

template <class YOp, class Tile>
__global__ void __launch_bounds__(kX1Threads, Tile::MINB)
    tail_x1_kernel(TailArgs a, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1,
                   __nv_bfloat16* __restrict__ y,
                   __nv_bfloat16* __restrict__ x1, int64_t P, int C1) {
  constexpr int BM = Tile::BM, CN = Tile::CN, KC = Tile::KC, S = kX1Stages;
  constexpr int kPieces = KC / 8;   // 16-byte pieces a ring row
  constexpr int kSlice = BM * 128;  // bytes of 64 channels of the y tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (Tile::WG)
    smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int C = a.C;
  unsigned char* ys = smem;                          // [C / 64][BM][128 B]
  unsigned char* ring = smem + (size_t)BM * C * 2;   // [S][CN][2 KC B]
  const int64_t p0 = (int64_t)blockIdx.x * BM;
  const int kchunks = C / KC;
  const int steps = kchunks * (C1 / CN);

  // 0. step t's chunk: columns (t / kchunks) CN.., K (t % kchunks) KC..
  auto load_step = [&](int t) {
    const int n0 = (t / kchunks) * CN;
    const int k0 = (t % kchunks) * KC;
    unsigned char* st = ring + (t % S) * Tile::kStageBytes;
#pragma unroll
    for (int u = 0; u < CN * kPieces / kX1Threads; ++u) {
      const int i = threadIdx.x + u * kX1Threads;
      const int n = i / kPieces;
      const int q = i % kPieces;
      cp_async16(st + n * Tile::kRowBytes + (ring_piece<KC>(n, q) << 4),
                 w1 + (int64_t)(n0 + n) * C + k0 + q * 8, true);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  // 1. y for the tile
  if constexpr (Tile::YU > 0) {
    if (kX1Threads % (C >> 3) == 0 && P <= INT32_MAX - kX1Threads)
      tail_x1_y_rows<YOp, Tile::YU, Tile::YU == 2 ? 2 : 1>(a, p0, BM, P, y,
                                                           ys);
    else
      tail_x1_y_vectors<YOp>(a, p0, BM, P, y, ys);
  } else {
    tail_x1_y_vectors<YOp>(a, p0, BM, P, y, ys);
  }

  // 2. x1 = ys @ W1^T, then 3. bias + ReLU, bf16 pairs out: the value at
  //    (tile row r, column n) with its neighbour at n + 1.
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  auto store_pair = [&](int r, int n, float v0, float v1) {
    const int64_t p = p0 + r;
    if (p < P)
      *reinterpret_cast<uint32_t*>(x1 + p * C1 + n) = pack_bf16x2(
          fmaxf(v0 + __ldg(b1 + n), 0.f), fmaxf(v1 + __ldg(b1 + n + 1), 0.f));
  };
  int t = 0;
  if constexpr (Tile::WG) {
    // wgmma m64nNk16, N = CN / 2 columns a warpgroup
    constexpr int NW = CN / 2;
    const int wg = threadIdx.x >> 7;
    const int row = 16 * ((threadIdx.x >> 5) & 3) + g;
    for (int n0 = 0; n0 < C1; n0 += CN) {
      float acc[NW / 2];
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
      for (int kc = 0; kc < kchunks; ++kc, ++t) {
        cp_async_wait<S - 2>();  // this thread's copies of step t landed
        // its copies and y stores, seen by the tensor cores' reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // everyone's; and step t - 1's stage is free
        if (t + S - 1 < steps) load_step(t + S - 1);
        cp_async_commit();
        const uint64_t da = wgmma_desc(ys + kc * kSlice);
        const uint64_t db =
            wgmma_desc(ring + (t % S) * Tile::kStageBytes + wg * NW * 128);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // a k16 step: 32 bytes on
          if constexpr (NW == 32)
            wgmma_64x32x16(acc, da + 2 * ks, db + 2 * ks);
          else
            wgmma_64x64x16(acc, da + 2 * ks, db + 2 * ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int j = 0; j < NW / 2; ++j)
        asm volatile("" : "+f"(acc[j])::"memory");  // read only from here
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int n = n0 + wg * NW + 8 * j + 2 * tq;
        store_pair(row, n, acc[4 * j], acc[4 * j + 1]);
        store_pair(row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  } else {
    // mma.sync m16n8k16 with ldmatrix fragments.  Every row a lane
    // addresses is lane & 7 modulo 8, so its swizzle is fixed for the lane.
    constexpr int MT = Tile::MT, NT = Tile::NT;
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp % Tile::WM) * (16 * MT);
    const int col0 = (warp / Tile::WM) * (8 * NT);
    const int a_row = (row0 + (lane & 15)) * 128;  // A: rows row0 + lane % 16,
    const int a_hi = lane >> 4;                     // pieces + lane / 16
    const int b_row = (col0 + (lane & 7) + ((lane >> 4) << 3)) *
                      Tile::kRowBytes;              // B: two n8 tiles,
    const int b_hi = (lane >> 3) & 1;               // pieces + (lane / 8) % 2
    const int a_swz = lane & 7;
    const int b_swz = KC == 64 ? lane & 7 : (lane & 7) >> 1;
    for (int n0 = 0; n0 < C1; n0 += CN) {
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
      for (int kc = 0; kc < kchunks; ++kc, ++t) {
        cp_async_wait<S - 2>();
        __syncthreads();
        if (t + S - 1 < steps) load_step(t + S - 1);
        cp_async_commit();
        const unsigned char* st = ring + (t % S) * Tile::kStageBytes;
        const unsigned char* yk = ys + ((kc * KC) >> 6) * kSlice + a_row;
        const int q0 = ((kc * KC) & 63) >> 3;  // K chunk's first piece
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(af[mt], yk + mt * 16 * 128 +
                                    (((q0 + 2 * ks + a_hi) ^ a_swz) << 4));
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, st + b_row + j * 8 * Tile::kRowBytes +
                                (((2 * ks + b_hi) ^ b_swz) << 4));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(acc[mt][j], af[mt], bf[0], bf[1]);
              mma_16816(acc[mt][j + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + col0 + 8 * j + 2 * tq;
          const int r = row0 + mt * 16 + g;
          store_pair(r, n, acc[mt][j][0], acc[mt][j][1]);
          store_pair(r + 8, n, acc[mt][j][2], acc[mt][j][3]);
        }
    }
  }
  cp_async_wait<0>();
}

// The tiles both entry points pick from up to C = 1024, by
// tail_x1_with_tile (the row tail adds its own above): 64 pixels, the
// product on wgmma; 64 columns a chunk, two blocks an SM (128 registers a
// thread), y one pixel at a time, up to C = 256 or where C1 is no multiple
// of 128; above, 128 columns, one block an SM, y two pixels at a time with
// the 3x3 weights in registers.
using X1Tile64x64 = X1Tile<4, 1, 4, 64, 2, 1, 1>;
using X1Tile64x128 = X1Tile<2, 2, 4, 64, 1, 2, 1>;

template <class F>
cudaError_t tail_x1_with_tile(int C, int C1, F&& f) {
  if (C > 256 && C1 % 128 == 0) return f(X1Tile64x128{});
  return f(X1Tile64x64{});
}

// Lets tail_x1_kernel<YOp, Tile> take `smem` bytes of dynamic shared
// memory on the current device.  cudaFuncSetAttribute runs only when a
// launch needs more than was allowed so far, not on every launch; it fails
// when `smem` exceeds what a block may have.
template <class YOp, class Tile>
cudaError_t tail_x1_allow_smem(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(tail_x1_kernel<YOp, Tile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

// y [B, H, W, C] and x1 [B, H, W, C1] for P = B H W pixels; C a multiple of
// 64, C1 of Tile::CN, Tile::smem_bytes(C) <= kMaxSmem.
template <class YOp, class Tile>
cudaError_t tail_x1_launch(const TailArgs& a, const void* w1, const void* b1,
                           void* y, void* x1, int64_t P, int C1,
                           cudaStream_t stream) {
  const size_t smem = Tile::smem_bytes(a.C);
  cudaError_t err = tail_x1_allow_smem<YOp, Tile>(smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (P + Tile::BM - 1) / Tile::BM;
  if (blocks > 0) {
    tail_x1_kernel<YOp, Tile><<<(unsigned)blocks, kX1Threads, smem, stream>>>(
        a, static_cast<const __nv_bfloat16*>(w1),
        static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(x1), P, C1);
  }
  return cudaGetLastError();
}

// What a launch at C channels would be: out[0] blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] pixels a block,
// out[2] x1 columns a chunk, out[3] ring stages, out[4] K chunk depth,
// out[5] shared memory bytes a block.
template <class YOp, class Tile>
cudaError_t tail_x1_describe(int C, int out[6]) {
  const size_t smem = Tile::smem_bytes(C);
  cudaError_t err = tail_x1_allow_smem<YOp, Tile>(smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], tail_x1_kernel<YOp, Tile>, kX1Threads, smem);
  out[1] = Tile::BM;
  out[2] = Tile::CN;
  out[3] = kX1Stages;
  out[4] = Tile::KC;
  out[5] = (int)smem;
  return err;
}

}  // namespace
