// DeiT MRLA-light token tail, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/deit_token_tail.py
// (deit_token_tail -> _kernel).  Per image, x and ot [N, C] bf16 with
// N = 1 + S * S (row 0 the cls token, rows 1.. the S x S grid, row-major):
//
//     normx = LN_x(x); normo = LN_o(ot)              eps 1e-6, over C, fp32
//     gap   = mean over the grid rows of normx
//     q, k  = ktap-tap SAME cross-correlation of gap along C with wq, wk
//     gate  = sigmoid(sum over each head's d channels of q * k / sqrt(d))
//     v     = gelu_erf(dwconv3x3(normx_grid))        zero outside the grid
//     out_grid = x_grid + v * gate[head of c] + lam * normo_grid
//     out_cls  = x_cls + normx_cls
//
// Bound on an H100: memory.  x and ot are read and out is written once,
// 6 bytes an element: [128, 197, 384] is 58.1 MB, 0.0173 ms at 3.35 TB/s.
// The instructions are not far behind: some 60 an element, 25 of them the
// erf, so the design counts instructions an element as well as bytes.
//
// Design: two passes over memory behind one C entry point.  The image's
// mean over its grid rows is a barrier every grid row waits on; the launch
// boundary is that barrier.
//   1. A block per image reads x and ot once.  Each warp takes every
//      kWarps-th row: a lane copies its 16-byte pieces of the row by
//      cp.async into the warp's ring of rows in shared memory, K rows
//      ahead, and reads back only its own.  Two rows at a time (their
//      shuffles interleaved), the warp takes each row's mean and rstd (two
//      passes over registers: mean, then mean((x - mean)^2)) and writes
//      (rstd, -mean * rstd) for pass 2, finishes the cls row (x + LN_x(x))
//      and adds each grid row's (x - mean) * rstd to per-lane channel sums.
//      The block then sums its warps' sums in warp order, runs the two
//      channel convolutions and each head's q * k and writes the image's
//      [C] gate.  No partial sums leave the block and nothing is atomic:
//      two launches are bitwise equal.  Its first instruction lets pass 2
//      launch (programmatic dependent launch).
//   2. A thread per 8 channels of one grid row walks the row's S pixels with
//      a sliding 3x3 window, as csrc/tail_window.cuh does for the ResNet
//      tails, but over the token grid and with normx formed on the fly: for
//      each pixel one new column (x of rows h - 1, h, h + 1 and ot of row h,
//      four 16-byte copies) comes by cp.async into the thread's ring in
//      shared memory, kStages - 1 columns ahead.  Each column is normalised
//      once, u = x * rstd - mean * rstd, and its nine tap products go
//      straight into the three outputs it touches (the pixel to its left,
//      its own, the one to its right), so the window holds three 8-channel
//      sums rather than three columns.  LN_x's weight is folded into the
//      taps and its bias into each sum's first term.  The taps sit in
//      shared memory, once a block: in registers they took a thread to 236
//      registers and an SM to six warps; so, 167 registers and four blocks
//      of 96 threads an SM.  The image's gate, lam * LN_o's weight and bias
//      stay in registers.
//      Outside the grid a neighbour is zero: rows above and below come from
//      the pixel's own image only (never the cls row or another image's
//      token).  Before it waits for pass 1 the block loads its constants
//      and starts its first columns, none of which pass 1 writes; what
//      pass 1 writes it reads at L2 (ld.global.cg).
// Device memory sees x twice (pass 2's rows above and below mostly from
// L2), ot twice and out once; the scratch is the gate and 16 bytes a row.
// ot's statistics taken in pass 2 instead (one barrier a pixel where its
// C / 8 threads meet) read ot once but were slower at every width, and so
// was pass 2 as an ordinary launch: tune_deit_tail.py --phases times them
// and the other launch choices from a copy with each a macro
// (tune_deit_tail_passes.cu).
#include <math.h>

#include <mutex>
#include <type_traits>

#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

// The launch, chosen by measurement (tune_deit_tail.py --phases): pass 2's
// ring of columns, its threads a block (a block is as many grid rows of
// C / 8 threads as fit) and the shared memory of pass 1's rings.
constexpr int kStages = 4;
constexpr int kPass2Threads = 96;
constexpr size_t kPass1RingBytes = 96 * 1024;

constexpr int kWarps = 16;         // warps of a pass-1 block
constexpr int kMaxVec = 4;         // 8-channel vectors a lane holds: C <= 1024
constexpr int kMaxThreads = 192;   // of a pass-2 block
constexpr int kPass2MinBlocks = 2;  // resident an SM: at most 168 registers
constexpr int kMaxSide = 29;       // S: N <= 1 + 29 * 29 = 842
constexpr float kEps = 1e-6f;

// rows of the packed [14, C] fp32 parameter array
constexpr int kLnxW = 0, kLnxB = 1, kLnoW = 2, kLnoB = 3, kLam = 4, kWv = 5;

typedef __nv_bfloat16 bf16;

// Programmatic dependent launch: the primary lets its dependent launch; the
// dependent waits until the primary has finished and its writes are seen.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// (rstd, -mean * rstd) of M rows of C values at once, each spread over a
// warp (lane l holds the 8-channel vectors l, l + 32, ... below `vecs` in
// r[m][0], r[m][1], ...), each variance mean((x - mean)^2), the rows'
// shuffles interleaved.
template <int NV, int M>
__device__ __forceinline__ void row_norms(const float (&r)[M][NV][8],
                                          int lane, int vecs, float inv_c,
                                          float2 (&out)[M]) {
  float s[M], q[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    s[m] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < vecs) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[m] += r[m][i][j];
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] += __shfl_xor_sync(0xffffffffu, s[m], o);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    s[m] *= inv_c;  // the mean
    q[m] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < vecs) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = r[m][i][j] - s[m];
          q[m] = fmaf(d, d, q[m]);
        }
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) q[m] += __shfl_xor_sync(0xffffffffu, q[m], o);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float rstd = rsqrtf(q[m] * inv_c + kEps);
    out[m] = make_float2(rstd, -s[m] * rstd);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  const float h = 0.5f * v;
  return fmaf(h, erff(v * 0.70710678118654752440f), h);
}

// Rows a pass-1 warp has in flight: a ring of row slots in shared memory, a
// slot x's row and ot's of up to 256 * NV channels each, as many as fit
// kPass1RingBytes for the block's warps, 2 to 8.
__host__ __device__ constexpr int clamp_depth(size_t k) {
  return k < 2 ? 2 : k > 8 ? 8 : (int)k;
}
template <int NV>
__host__ __device__ constexpr int pass1_depth() {
  return clamp_depth(kPass1RingBytes / (kWarps * 2 * 256 * NV * 2));
}

// Pass 1's shared memory, in bytes: the warps' rings, which the warps'
// channel sums, gap and q * k take over once every row is in.
template <int NV>
constexpr size_t pass1_smem(int C) {
  const size_t ring = (size_t)kWarps * pass1_depth<NV>() * 2 * C * 2;
  const size_t sums = (size_t)(kWarps + 2) * C * sizeof(float);
  return ring > sums ? ring : sums;
}

// Pass 1.  grid B; block kWarps warps; dynamic shared memory
// pass1_smem<NV>(C); NV = the 8-channel vectors a lane holds,
// C <= 256 * NV.  nx[row], no[row]: (rstd, -mean * rstd) of every row of x
// and of ot; out's cls row; gate[b][c].  taps: [2, ktap], wq then wk; tap j
// reads channel c + j - (ktap - 1) / 2, zero outside [0, C).  Warp w takes
// rows w, w + kWarps, ...; a lane copies its own 16-byte pieces of each row
// by cp.async into the warp's ring, K rows ahead, and reads back only
// those, so no barrier is needed until the sums.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    deit_tail_pass1_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ ot,
                           const float* __restrict__ vec,
                           const float* __restrict__ taps,
                           float2* __restrict__ nx, float2* __restrict__ no,
                           float* __restrict__ gate, bf16* __restrict__ out,
                           int N, int C, int d, int ktap) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char pass1_raw[];
  constexpr int K = pass1_depth<NV>();
  constexpr int kPieces = 2;  // x's row, then ot's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int vecs = C / 8;
  const float inv_c = 1.f / (float)C;
  uint4* const wring =  // this warp's K slots of [kPieces][C / 8] pieces
      reinterpret_cast<uint4*>(pass1_raw) + (size_t)warp * K * kPieces * vecs;

  // row r into slot k (an empty group past the last row)
  auto fetch = [&](int k, int r) {
    if (r < N) {
      const int64_t at = ((int64_t)b * N + r) * vecs;
      uint4* slot = wring + k * kPieces * vecs;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = lane + 32 * i;
        if (v < vecs) {
          cp_async16(slot + v, reinterpret_cast<const uint4*>(x) + at + v,
                     true);
          cp_async16(slot + vecs + v,
                     reinterpret_cast<const uint4*>(ot) + at + v, true);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < K; ++k) fetch(k, warp + k * kWarps);

  float sum[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum[i][j] = 0.f;

  // kRows rows an iteration (consecutive slots), their reductions
  // interleaved: M rows of values, x's then ot's
  constexpr int kRows = NV <= 2 ? 2 : 1;
  constexpr int M = kRows * kPieces;
  int ks = 0;  // the slot of row r
  for (int r = warp; r < N; r += kRows * kWarps) {
    cp_async_wait<K - kRows>();
    float t[M][NV][8];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const uint4* slot = wring + ks * kPieces * vecs;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (lane + 32 * i < vecs) {
          bf16x8_to_float(slot[lane + 32 * i], t[u][i]);
          bf16x8_to_float(slot[vecs + lane + 32 * i], t[kRows + u][i]);
        }
      fetch(ks, r + (K + u) * kWarps);  // the slot is read: refill it
      if (++ks == K) ks = 0;
    }
    float2 nrm[M];
    row_norms<NV, M>(t, lane, vecs, inv_c, nrm);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int rr = r + u * kWarps;
      if (rr >= N) break;
      const int64_t row = (int64_t)b * N + rr;
      const float2 st = nrm[u];
      if (lane == 0) {
        nx[row] = st;
        no[row] = nrm[kRows + u];
      }
      if (rr == 0) {  // the cls row: x + LN_x(x); no MRLA term, no ot
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c0 = (lane + 32 * i) * 8;
          if (c0 < C) {
            float w[8], bi[8], y[8];
            load_f8(vec + kLnxW * C + c0, w);
            load_f8(vec + kLnxB * C + c0, bi);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              y[j] = t[u][i][j] +
                     fmaf(fmaf(t[u][i][j], st.x, st.y), w[j], bi[j]);
            *reinterpret_cast<uint4*>(out + row * C + c0) = pack_bf16x8(y);
          }
        }
      } else {  // a grid row: (x - mean) * rstd goes into the image's mean
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (lane + 32 * i < vecs) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              sum[i][j] += fmaf(t[u][i][j], st.x, st.y);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is read: the sums take the space over

  float* acc = reinterpret_cast<float*>(pass1_raw);  // [kWarps][C], gap, qk
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (lane + 32 * i) * 8;
    if (c0 < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[warp * C + c0 + j] = sum[i][j];
    }
  }
  __syncthreads();
  float* gap = acc + kWarps * C;
  float* qk = gap + C;
  const float inv_grid = 1.f / (float)(N - 1);
  for (int c = threadIdx.x; c < C; c += kWarps * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * C + c];
    // the mean of normx = w * mean((x - mean) * rstd) + b
    gap[c] = fmaf(s * inv_grid, __ldg(vec + kLnxW * C + c),
                  __ldg(vec + kLnxB * C + c));
  }
  __syncthreads();
  const int pad = (ktap - 1) / 2;
  for (int c = threadIdx.x; c < C; c += kWarps * 32) {
    float q = 0.f, k = 0.f;
    for (int j = 0; j < ktap; ++j) {
      const int cc = c + j - pad;
      if (cc >= 0 && cc < C) {
        q = fmaf(__ldg(taps + j), gap[cc], q);
        k = fmaf(__ldg(taps + ktap + j), gap[cc], k);
      }
    }
    qk[c] = q * k;
  }
  __syncthreads();
  const float scale = 1.f / sqrtf((float)d);
  for (int c = threadIdx.x; c < C; c += kWarps * 32) {
    const int h0 = c / d * d;  // first channel of this channel's head
    float s = 0.f;
    for (int i = 0; i < d; ++i) s += qk[h0 + i];
    gate[(int64_t)b * C + c] = 1.f / (1.f + expf(-s * scale));
  }
}

struct Pass2Args {
  const bf16* x;
  const bf16* ot;
  const float* vec;
  const float2* nx;    // (rstd, -mean * rstd) of every row of x
  const float2* no;    // of ot
  const float* gate;   // [B, C]
  bf16* out;
  int B, N, S, C;
  int rows;            // grid rows a block
};

// A thread's 9 taps of 8 channels in shared memory: 72 floats and 4 of
// padding, so that the 16-byte loads of 8 neighbouring threads fall in
// distinct banks.
constexpr int kTapStride = 76;

// Pass 2's shared memory, in bytes: the taps [C / 8][kTapStride] fp32
// (LN_x's weight folded in), the ring [kStages][4][threads] of 16-byte
// pieces and each grid row's statistics [rows][4][S] (x of rows h - 1, h,
// h + 1, then ot of row h).
__host__ __device__ constexpr size_t pass2_smem(int threads, int rows, int S,
                                                int C) {
  return (size_t)C / 8 * kTapStride * 4 +
         (size_t)kStages * 4 * threads * 16 + (size_t)rows * 4 * S * 8;
}

// Loads of what pass 1 writes: at L2 (ld.global.cg), never through the
// read-only path, whose contents need not see writes made while this grid
// was already running (a dependent launch starts before pass 1 ends).
__device__ __forceinline__ void load_f8_cg(const float* p, float f[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void lds_f8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Pass 2.  grid ceil(B * S / rows); block rows * C / 8 threads (row rs of
// the block, 8 channels c0 = 8 * (tid % (C / 8))); dynamic shared memory
// pass2_smem.  A thread finishes out for its channels of the S pixels of
// grid row h of image img.  Threads past the last grid row load nothing
// and store nothing but meet the others at the barrier.
__global__ void __launch_bounds__(kMaxThreads, kPass2MinBlocks)
    deit_tail_pass2_kernel(Pass2Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int S = a.S, C = a.C, V = C >> 3;
  const int tid = threadIdx.x;
  float* taps = reinterpret_cast<float*>(smem_raw);
  uint4* ring = reinterpret_cast<uint4*>(taps + V * kTapStride);
  float2* stats = reinterpret_cast<float2*>(ring + kStages * 4 * nt);

  const int rs = tid / V, vi = tid - rs * V;
  const int c0 = vi * 8;
  const int64_t grow = (int64_t)blockIdx.x * a.rows + rs;
  const bool active = grow < (int64_t)a.B * S;
  const int64_t img = active ? grow / S : 0;
  const int h = active ? (int)(grow - img * S) : 0;
  const bool top = active && h > 0, bottom = active && h + 1 < S;
  const int64_t row0 = img * a.N + 1 + (int64_t)h * S;  // token (img, h, 0)
  const float* tp = taps + vi * kTapStride;  // this thread's taps

  // Constants for the whole row (none of them written by pass 1).  LN_x's
  // weight is folded into the taps and its bias into the sums' first
  // terms: sum over the valid taps t of wv_t * (u_t * w + b) = sum of
  // (wv_t * w) * u_t + b * (sum of the valid wv_t), u = x * rstd - mean *
  // rstd.  full: b * the sum over a pixel's valid taps inside the row
  // (rows h - 1 and h + 1 where they are in the grid); last: the same
  // without the right column (the row's last pixel); first: without the
  // left (the first).
  float full[8], last[8], first[8], lw[8], lb[8];
  {
    float w[8], b[8], wv[8];
    load_f8(a.vec + kLnxW * C + c0, w);
    load_f8(a.vec + kLnxB * C + c0, b);
    float col[3][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) col[0][i] = col[1][i] = col[2][i] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      load_f8(a.vec + (kWv + t) * C + c0, wv);
      const bool valid = (t / 3 != 0 || top) && (t / 3 != 2 || bottom);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (valid) col[t % 3][i] += wv[i];
        wv[i] *= w[i];
      }
      if (rs == 0) {  // one row of the block writes the folded taps
        float4* dst =
            reinterpret_cast<float4*>(taps + vi * kTapStride) + 2 * t;
        dst[0] = make_float4(wv[0], wv[1], wv[2], wv[3]);
        dst[1] = make_float4(wv[4], wv[5], wv[6], wv[7]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      full[i] = b[i] * (col[0][i] + col[1][i] + col[2][i]);
      last[i] = b[i] * (col[0][i] + col[1][i]);
      first[i] = b[i] * (S > 1 ? col[1][i] + col[2][i] : col[1][i]);
    }
    float wo[8], bo[8], lam[8];
    load_f8(a.vec + kLnoW * C + c0, wo);
    load_f8(a.vec + kLnoB * C + c0, bo);
    load_f8(a.vec + kLam * C + c0, lam);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lw[i] = lam[i] * wo[i];  // lam * normo = (ot * rstd - mean * rstd)
      lb[i] = lam[i] * bo[i];  //   * lam * w + lam * b
    }
  }

  // The column feed: column j of the row is x of rows h - 1, h, h + 1 and
  // ot of row h, four 16-byte pieces into the next ring stage, a commit
  // group each; rows outside the grid and columns past the row are
  // zero-filled.  The sources advance a column a copy and stay on the
  // row's last column past it (so every address is in the tensor).
  const bf16* xs0 = a.x + (row0 + (top ? -S : 0)) * C + c0;
  const bf16* xs1 = a.x + row0 * C + c0;
  const bf16* xs2 = a.x + (row0 + (bottom ? S : 0)) * C + c0;
  const bf16* os = a.ot + row0 * C + c0;
  uint4* const ring_end = ring + kStages * 4 * nt;
  uint4* feed = ring + tid;
  int feed_col = 0;
  auto issue = [&]() {
    const bool col = active && feed_col < S;
    cp_async16(feed, xs0, col && top);
    cp_async16(feed + nt, xs1, col);
    cp_async16(feed + 2 * nt, xs2, col && bottom);
    cp_async16(feed + 3 * nt, os, col);
    cp_async_commit();
    if (++feed_col < S) {
      xs0 += C;
      xs1 += C;
      xs2 += C;
      os += C;
    }
    feed += 4 * nt;
    if (feed >= ring_end) feed -= kStages * 4 * nt;
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue();

  wait_for_primary();  // pass 1's gate and statistics
  float gt[8];
  if (active) {
    load_f8_cg(a.gate + img * C + c0, gt);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) gt[i] = 0.f;
  }
  // statistics of the row's x rows h - 1, h, h + 1 and of ot row h
  float2* st = stats + rs * 4 * S;
  for (int k = vi; k < 4 * S; k += V) {
    const int r = k / S, j = k - r * S;
    float2 v = make_float2(0.f, 0.f);
    if (r < 3) {
      if (active && (r != 0 || top) && (r != 2 || bottom))
        v = __ldcg(a.nx + row0 + (int64_t)(r - 1) * S + j);
    } else if (active) {
      v = __ldcg(a.no + row0 + j);
    }
    st[k] = v;
  }
  __syncthreads();  // the taps and the statistics

  // acc[p % 3]: the depthwise sum of output pixel p; the left column's taps
  // go in first, then the centre's, then the right's
  float acc[3][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[0][i] = first[i];
  uint4 xc = make_uint4(0, 0, 0, 0), oc = xc;  // pixel j - 1's x and ot
  float2 on = make_float2(0.f, 0.f);           // and its ot statistics
  bf16* dst = a.out + row0 * C + c0;           // pixel j - 1's out
  const uint4* src = ring + tid;               // column j's stage
  // out of the pixel before column j from its depthwise sum, x and ot
  auto finish = [&](const float (&s)[8]) {
    float xf[8], of[8], y[8];
    bf16x8_to_float(xc, xf);
    bf16x8_to_float(oc, of);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      y[i] = fmaf(gelu_erf(s[i]), gt[i], xf[i]) +
             fmaf(fmaf(of[i], on.x, on.y), lw[i], lb[i]);
    if (active) *reinterpret_cast<uint4*>(dst) = pack_bf16x8(y);
    dst += C;
  };

  // Step j < S: column j comes in; its taps go into pixels j - 1, j and
  // j + 1 (in acc[K2], acc[K], acc[K1] with K = j % 3), and pixel j - 1 is
  // finished.
  auto step = [&](auto k_, int j) {
    constexpr int K = decltype(k_)::value;
    constexpr int K1 = (K + 1) % 3, K2 = (K + 2) % 3;
    cp_async_wait<kStages - 2>();
    const uint4* col = src;
    src += 4 * nt;
    if (src >= ring_end) src -= kStages * 4 * nt;
    issue();  // into the stage of column j - 1, read a step ago
    const uint4 orw = col[3 * nt];
    // the column's rows, h first (always in the grid)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int r = t == 0 ? 1 : t == 1 ? 0 : 2;
      if ((r == 0 && !top) || (r == 2 && !bottom)) continue;
      const float2 sn = st[r * S + j];
      float u[8], w[8];
      bf16x8_to_float(col[r * nt], u);
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = fmaf(u[i], sn.x, sn.y);
      if (j > 0) {
        lds_f8(tp + 8 * (r * 3 + 2), w);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[K2][i] = fmaf(u[i], w[i], acc[K2][i]);
      }
      lds_f8(tp + 8 * (r * 3 + 1), w);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[K][i] = fmaf(u[i], w[i], acc[K][i]);
      if (j + 1 < S) {
        lds_f8(tp + 8 * (r * 3), w);
        if (r == 1) {
          const bool end = j + 2 == S;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[K1][i] = fmaf(u[i], w[i], end ? last[i] : full[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[K1][i] = fmaf(u[i], w[i], acc[K1][i]);
        }
      }
    }
    if (j > 0) finish(acc[K2]);
    xc = col[nt];  // pixel j's x, ot and statistics, for its finish a
    oc = orw;      // step later
    on = st[3 * S + j];
  };
  // the step past the last column: pixel S - 1 (in acc[(K + 2) % 3], K =
  // S % 3) is finished
  auto last_step = [&](auto k_) {
    constexpr int K2 = (decltype(k_)::value + 2) % 3;
    finish(acc[K2]);
  };

  const std::integral_constant<int, 0> k0{};
  const std::integral_constant<int, 1> k1{};
  const std::integral_constant<int, 2> k2{};
  int j = 0;
  for (; j + 3 <= S; j += 3) {
    step(k0, j);
    step(k1, j + 1);
    step(k2, j + 2);
  }
  switch (S - j) {
    case 0: last_step(k0); break;
    case 1: step(k0, j); last_step(k1); break;
    default: step(k0, j); step(k1, j + 1); last_step(k2); break;
  }
  cp_async_wait<0>();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device; cudaFuncSetAttribute runs only when a launch needs more than was
// allowed so far.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  constexpr int kMaxDevices = 64, kMaxKernels = 16;
  static std::mutex mu;
  static const void* kernels[kMaxKernels] = {};
  static size_t allowed[kMaxKernels][kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  int k = 0;
  while (k < kMaxKernels && kernels[k] && kernels[k] != kernel) ++k;
  if (k == kMaxKernels) return cudaErrorInvalidValue;
  kernels[k] = kernel;
  if (smem <= allowed[k][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[k][dev] = smem;
  return err;
}

// the side of the square grid behind N - 1 rows, or 0
int grid_side(int N) {
  if (N < 2) return 0;
  int s = (int)lround(sqrt((double)(N - 1)));
  return s * s == N - 1 ? s : 0;
}

bool supported(int N, int C, int d, int ktap) {
  const int s = grid_side(N);
  return s > 0 && s <= kMaxSide && C > 0 && C % 32 == 0 &&
         C <= 8 * 32 * kMaxVec && d > 0 && C % d == 0 && ktap >= 1 &&
         ktap % 2 == 1;
}

// grid rows of a pass-2 block: as many rows of C / 8 threads as fit
// kPass2Threads, at least one
int pass2_rows(int C) { return max(1, kPass2Threads / (C / 8)); }

// The scratch of B images: the gate [B, C], then x's and ot's row
// statistics [B * N] float2 each.
struct Scratch {
  float* gate;
  float2* nx;
  float2* no;
};

Scratch scratch_of(void* scratch, int B, int N, int C) {
  float* gate = static_cast<float*>(scratch);
  float2* nx = reinterpret_cast<float2*>(gate + (int64_t)B * C);
  return Scratch{gate, nx, nx + (int64_t)B * N};
}

size_t pass1_bytes(int C) {
  switch ((C / 8 + 31) / 32) {  // 8-channel vectors a lane holds
    case 1: return pass1_smem<1>(C);
    case 2: return pass1_smem<2>(C);
    case 3: return pass1_smem<3>(C);
  }
  return pass1_smem<kMaxVec>(C);
}

template <int NV>
cudaError_t launch_pass1(const bf16* x, const bf16* ot, const float* vec,
                         const float* taps, const Scratch& sc, bf16* out,
                         int B, int N, int C, int d, int ktap,
                         cudaStream_t s) {
  const auto kernel = deit_tail_pass1_kernel<NV>;
  const size_t smem = pass1_smem<NV>(C);
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kWarps * 32, smem, s>>>(x, ot, vec, taps, sc.nx, sc.no,
                                      sc.gate, out, N, C, d, ktap);
  return cudaGetLastError();
}

cudaError_t launch_pass2(const bf16* x, const bf16* ot, const float* vec,
                         const Scratch& sc, bf16* out, int B, int N, int C,
                         cudaStream_t s) {
  const int S = grid_side(N), rows = pass2_rows(C);
  const int threads = rows * (C / 8);
  const int64_t blocks = ((int64_t)B * S + rows - 1) / rows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = pass2_smem(threads, rows, S, C);
  const auto kernel = deit_tail_pass2_kernel;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const Pass2Args a{x, ot, vec, sc.nx, sc.no, sc.gate, out, B, N, S, C, rows};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The fp32 values of scratch the launch needs for each image (the gate and
// the rows' statistics of x and of ot), or -1 for shapes the kernel does not
// take.
extern "C" int deit_token_tail_scratch_per_image(int N, int C, int d,
                                                 int ktap) {
  if (!supported(N, C, d, ktap)) return -1;
  return C + 4 * N;
}

// x, ot, out: [B, N, C] bf16, N - 1 a square; vec: [14, C] fp32 (rows: LN_x
// weight, bias; LN_o weight, bias; lam; the nine depthwise taps in
// (dh + 1) * 3 + (dw + 1) order); taps: [2, ktap] fp32; scratch: B times
// deit_token_tail_scratch_per_image fp32 values.  Takes C % 32 == 0,
// C <= 1024, a grid of at most 29 x 29 tokens (N <= 842), heads of d
// channels with C % d == 0 and an odd ktap; anything else is
// cudaErrorInvalidValue.
extern "C" int deit_token_tail_bf16(const void* x, const void* ot,
                                    const void* vec, const void* taps,
                                    void* scratch, void* out, int B, int N,
                                    int C, int d, int ktap, void* stream) {
  if (B < 0 || !supported(N, C, d, ktap) || B > 0x7fffffff / N)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = scratch_of(scratch, B, N, C);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ob = static_cast<const bf16*>(ot);
  const float* fvec = static_cast<const float*>(vec);
  bf16* o = static_cast<bf16*>(out);
  auto pass1 = launch_pass1<kMaxVec>;
  switch ((C / 8 + 31) / 32) {  // 8-channel vectors a lane holds
    case 1: pass1 = launch_pass1<1>; break;
    case 2: pass1 = launch_pass1<2>; break;
    case 3: pass1 = launch_pass1<3>; break;
  }
  cudaError_t err = pass1(xb, ob, fvec, static_cast<const float*>(taps), sc,
                          o, B, N, C, d, ktap, s);
  if (err == cudaSuccess) err = launch_pass2(xb, ob, fvec, sc, o, B, N, C, s);
  return (int)err;
}

// What a launch at [B, N, C] runs: out[0..4] pass 1's and out[5..9] pass
// 2's registers a thread, local (spilled) bytes a thread, static and
// dynamic shared memory bytes a block and blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[10] pass 2's threads
// a block, out[11] its grid rows a block, out[12] its blocks, out[13]
// columns in a thread's ring, out[14] pass 1's threads a block.
extern "C" int deit_token_tail_describe(int B, int N, int C, int* out) {
  if (B < 0 || !supported(N, C, 16, 1)) return (int)cudaErrorInvalidValue;
  const void* pass1 = (const void*)deit_tail_pass1_kernel<kMaxVec>;
  switch ((C / 8 + 31) / 32) {
    case 1: pass1 = (const void*)deit_tail_pass1_kernel<1>; break;
    case 2: pass1 = (const void*)deit_tail_pass1_kernel<2>; break;
    case 3: pass1 = (const void*)deit_tail_pass1_kernel<3>; break;
  }
  const int S = grid_side(N), rows = pass2_rows(C);
  const int threads = rows * (C / 8);
  const void* fns[2] = {pass1, (const void*)deit_tail_pass2_kernel};
  const int block[2] = {kWarps * 32, threads};
  const size_t dyn[2] = {pass1_bytes(C), pass2_smem(threads, rows, S, C)};
  for (int k = 0; k < 2; ++k) {
    cudaError_t err = allow_smem(fns[k], dyn[k]);
    cudaFuncAttributes at;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, fns[k]);
    if (err != cudaSuccess) return (int)err;
    int* o = out + 5 * k;
    o[0] = at.numRegs;
    o[1] = (int)at.localSizeBytes;
    o[2] = (int)at.sharedSizeBytes;
    o[3] = (int)dyn[k];
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[4], fns[k],
                                                        block[k], dyn[k]);
    if (err != cudaSuccess) return (int)err;
  }
  out[10] = threads;
  out[11] = rows;
  out[12] = (int)(((int64_t)B * S + rows - 1) / rows);
  out[13] = kStages;
  out[14] = kWarps * 32;
  return (int)cudaSuccess;
}
