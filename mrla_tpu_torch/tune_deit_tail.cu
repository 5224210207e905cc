// A design of the DeiT MRLA-light token tail that was measured and not
// taken: one pass over memory, an image to a thread-block cluster.  The
// three launches then on the path (tune_deit_tail_launches.cu) were faster
// at C = 384 and 768, and so is the library's kernel that replaced them
// (csrc/deit_token_tail.cu, two passes); tune_deit_tail.py builds this file
// on its own and times it at every cluster size beside the library's.  It
// is on no path.
//
// Per image, x and ot [N, C] bf16 with N = 1 + S * S (row 0 the cls token,
// rows 1.. the S x S grid, row-major):
//
//     normx = LN_x(x); normo = LN_o(ot)              eps 1e-6, over C, fp32
//     gap   = mean over the grid rows of normx
//     q, k  = ktap-tap SAME cross-correlation of gap along C with wq, wk
//     gate  = sigmoid(sum over each head's d channels of q * k / sqrt(d))
//     v     = gelu_erf(dwconv3x3(normx_grid))        zero outside the grid
//     out_grid = x_grid + v * gate[head of c] + lam * normo_grid
//     out_cls  = x_cls + normx_cls
//
// Design: one pass over memory, an image to a thread-block cluster.  The
// image's mean over its grid rows is a barrier that every row waits on, and
// one image (2 * N * C * 2 bytes of x and ot, 303 KB at [197, 384]) does
// not fit one block's shared memory; a cluster of cs blocks does.  Block k
// of the cluster owns channels [k C / cs, (k + 1) C / cs) of all N rows:
//   1. it stages its [N, C / cs] slice of x in shared memory, a bulk copy
//      (the TMA engine) a row, every copy in flight at once on one mbarrier.
//      ot is read from device memory where it is needed (its row
//      statistics, then each output's own value, the later reads from the
//      caches): with x alone a block's slice is half the size, and two
//      blocks share an SM, so at C = 192 and 384 all 128 images of a batch
//      are in flight at once;
//   2. row statistics need sums over all C: each block writes its rows'
//      partial sums (ot's 16-byte chunks read by a thread each, coalesced,
//      while x's copies land), the cluster meets at a barrier and every
//      block adds the cs partial sums of a row from the blocks' shared
//      memory (distributed shared memory), in rank order, so every block
//      holds the same mean.  Then the same for sum((v - mean)^2): the
//      variance stays two-pass, as the LayerNorm computes it;
//   3. the GAP is per channel and stays in the block; the channel taps read
//      the neighbours' GAP past the slice's edges, and a head's q * k sums
//      the products of channels that another block may own, both from that
//      block's shared memory after a cluster barrier;
//   4. a thread walks a segment of two grid rows for 4 channels with the
//      4 x 3 window of normx in registers, forming normx from the staged x
//      and its row's statistics as each new column enters (never stored for
//      a whole slice); out goes to device memory, 8 bytes a thread, a warp's
//      stores contiguous.
// Device memory sees x and ot once each and out once.  Sums run in a fixed
// order with no atomics: two launches are bitwise equal.  The cluster size
// cs is a power of two up to 16 (a non-portable size) whose slices fit a
// block; of those, the launch takes the one whose B images need the fewest
// rounds of the clusters the card holds at once times channels a block
// (pick_cluster; tune_deit_tail times every size).
#include <cooperative_groups.h>
#include <math.h>

#include <mutex>

#include "mrla_tail.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;  // what a block may have on sm_90
constexpr float kEps = 1e-6f;

// rows of the packed [14, C] fp32 parameter array
constexpr int kLnxW = 0, kLnxB = 1, kLnoW = 2, kLnoB = 3, kLam = 4, kWv = 5;

typedef __nv_bfloat16 bf16;

// GELU with the exact erf: 0.5 v (1 + erf(v / sqrt(2)))
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

// Row-partial sums a block keeps: pass 1 sum(x), sum(ot); pass 2
// sum((x - mean)^2), sum((ot - mean)^2); each pass its own arrays, so a
// neighbour may still read pass 1's while this block writes pass 2's.
constexpr int kParts = 4;

// Rows of GAP partial sums: the block's threads split the grid rows into
// this many interleaved chunks per channel pair, summed in chunk order.
__host__ __device__ constexpr int gap_chunks(int ch) {
  return kThreads / (ch / 2) > 0 ? kThreads / (ch / 2) : 1;
}

// Shared memory of a block with `ch` channels of N rows, in bytes: the x
// slice bf16 [N][ch]; partial row sums fp32 [kParts][N]; the rows'
// statistics float2 [2][N] ((rstd, -mean * rstd) of x, then of ot); gap,
// qk, gate fp32 [ch]; GAP partial sums fp32 [gap_chunks][ch]; the sums of
// ot's 8-channel chunks fp32 [N][ch / 8]; then, 8-byte aligned, the
// mbarrier of x's copies.
__host__ __device__ constexpr size_t barrier_offset(int N, int ch) {
  return ((size_t)N * ch * 2 + (size_t)N * kParts * 4 + (size_t)N * 16 +
          (size_t)3 * ch * 4 + (size_t)gap_chunks(ch) * ch * 4 +
          (size_t)N * (ch / 8) * 4 + 7) / 8 * 8;
}
__host__ __device__ constexpr size_t tail_smem(int N, int ch) {
  return barrier_offset(N, ch) + 8;
}

// A barrier of the cluster's threads whose shared-memory writes before it
// are seen by every block's reads after it (cluster scope: cooperative
// groups' cluster.sync() fences at GPU scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The GAP and q * k values of channel cc, wherever in the cluster it lives
// (this block's own from its shared memory directly).
__device__ __forceinline__ float cluster_value(cg::cluster_group& cluster,
                                               float* local, int cc, int ch,
                                               int rank) {
  const int owner = cc / ch;
  return owner == rank
             ? local[cc - owner * ch]
             : *cluster.map_shared_rank(local + (cc - owner * ch), owner);
}

// grid (cs, B), clusters (cs, 1, 1); block kThreads; dynamic shared memory
// tail_smem(N, C / cs).  taps: [2, ktap] (wq, then wk); tap j reads channel
// c + j - (ktap - 1) / 2, zero outside [0, C).
__global__ void __launch_bounds__(kThreads, 2)
    deit_tail_cluster_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ ot,
                             const float* __restrict__ vec,
                             const float* __restrict__ taps,
                             bf16* __restrict__ out, int N, int S, int C,
                             int d, int ktap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ch = C / cs;  // channels of this block
  const int c0 = rank * ch;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.y * N;
  const float inv_c = 1.f / (float)C;
  const int v8 = ch / 8;  // 16-byte chunks of a row's slice

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);               // [N][ch]
  float* part = reinterpret_cast<float*>(xs + (size_t)N * ch);  // [4][N]
  float2* stx = reinterpret_cast<float2*>(part + kParts * N);  // [N]
  float2* sto = stx + N;                                       // [N]
  float* gap = reinterpret_cast<float*>(sto + N);              // [ch]
  float* qk = gap + ch;                                        // [ch]
  float* gate = qk + ch;                                       // [ch]
  float* gpart = gate + ch;                    // [gap_chunks(ch)][ch]
  float* osum = gpart + gap_chunks(ch) * ch;   // [N][ch / 8]

  // 1. stage the slice of x: a bulk copy (the TMA engine) per row, all in
  // flight at once, completing on one mbarrier
  const uint32_t bar =
      (uint32_t)__cvta_generic_to_shared(smem_raw + barrier_offset(N, ch));
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"((uint32_t)(N * ch * 2))
        : "memory");
  for (int r = tid; r < N; r += kThreads)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"((uint32_t)__cvta_generic_to_shared(
            xs + (size_t)r * ch)),
        "l"(x + (row0 + r) * C + c0), "r"(ch * 2), "r"(bar)
        : "memory");

  // 2. row statistics.  ot is read from device memory in 16-byte chunks, a
  // thread per chunk (coalesced, every load in flight: the first pass while
  // x's copies land, the second from the caches), each chunk's sum kept in
  // shared memory; then a thread per row adds its chunks' sums and sums its
  // x from shared memory, 8 channels at a time, both starting at the row's
  // own rotation of the chunks (rows that share a bank start apart); then
  // the cluster adds the blocks' partial sums of each row in rank order.
  // sq: sums of squared deviations from the means in stx / sto.
  auto ot_chunks = [&](bool sq) {
    const uint4* src = reinterpret_cast<const uint4*>(ot + row0 * C + c0);
    constexpr int kAhead = 4;  // loads a thread has in flight
    for (int i0 = tid; i0 < N * v8; i0 += kAhead * kThreads) {
      uint4 raw[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = i0 + u * kThreads;
        const int r = i / v8, v = i - r * v8;
        if (i < N * v8) raw[u] = __ldg(src + (size_t)r * (C / 8) + v);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= N * v8) break;
        const int r = i / v8;
        float f[8];
        bf16x8_to_float(raw[u], f);
        const float m = sq ? sto[r].x : 0.f;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const float d0 = f[j] - m, d1 = f[j + 1] - m;
          a0 = sq ? fmaf(d0, d0, a0) : a0 + f[j];
          a1 = sq ? fmaf(d1, d1, a1) : a1 + f[j + 1];
        }
        osum[i] = a0 + a1;
      }
    }
  };
  auto row_sums = [&](int r, bool sq, float& sx, float& so) {
    const uint4* px = reinterpret_cast<const uint4*>(xs + (size_t)r * ch);
    const float mx = sq ? stx[r].x : 0.f;
    float ax[2] = {0.f, 0.f};
    float ao = 0.f;
    const int rot = r % v8;
    for (int i = 0; i < v8; ++i) {
      const int k = i + rot < v8 ? i + rot : i + rot - v8;
      float fx[8];
      bf16x8_to_float(px[k], fx);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dx = fx[j] - mx;
        ax[j & 1] = sq ? fmaf(dx, dx, ax[j & 1]) : ax[j & 1] + fx[j];
      }
      ao += osum[r * v8 + k];
    }
    sx = ax[0] + ax[1];
    so = ao;
  };
  auto cluster_sums = [&](int r, int at, float& sx, float& so) {
    sx = so = 0.f;
#pragma unroll 4
    for (int k = 0; k < cs; ++k) {
      const float* rp = cluster.map_shared_rank(part, k);
      sx += rp[at * N + r];
      so += rp[(at + 1) * N + r];
    }
  };
  ot_chunks(false);
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar)
      : "memory");
  __syncthreads();
  for (int r = tid; r < N; r += kThreads) {
    float sx, so;
    row_sums(r, false, sx, so);
    part[r] = sx;
    part[N + r] = so;
  }
  cluster_sync();
  for (int r = tid; r < N; r += kThreads) {
    float sx, so;
    cluster_sums(r, 0, sx, so);
    stx[r] = make_float2(sx * inv_c, 0.f);  // the means, for now
    sto[r] = make_float2(so * inv_c, 0.f);
  }
  __syncthreads();
  ot_chunks(true);
  __syncthreads();
  for (int r = tid; r < N; r += kThreads) {
    float qx, qo;
    row_sums(r, true, qx, qo);
    part[2 * N + r] = qx;
    part[3 * N + r] = qo;
  }
  cluster_sync();
  for (int r = tid; r < N; r += kThreads) {
    float qx, qo;
    cluster_sums(r, 2, qx, qo);
    const float rx = rsqrtf(qx * inv_c + kEps);
    const float ro = rsqrtf(qo * inv_c + kEps);
    stx[r] = make_float2(rx, -stx[r].x * rx);
    sto[r] = make_float2(ro, -sto[r].x * ro);
  }
  __syncthreads();

  // 3. GAP of this block's channels: normx = w * u + b with
  // u = (x - mean) * rstd, so gap = w * mean(u over grid rows) + b.  Each
  // thread sums a channel pair over every P-th grid row; the P partial sums
  // are added in chunk order.
  {
    const int P = gap_chunks(ch);
    const int pairs = ch / 2;
    for (int i = tid; i < P * pairs; i += kThreads) {
      const int chunk = i / pairs, pr = i - chunk * pairs;
      float a0 = 0.f, a1 = 0.f;
      for (int r = 1 + chunk; r < N; r += P) {
        const float2 s = stx[r];
        const float2 v = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(xs + (size_t)r * ch)[pr]);
        a0 += fmaf(v.x, s.x, s.y);
        a1 += fmaf(v.y, s.x, s.y);
      }
      gpart[chunk * ch + 2 * pr] = a0;
      gpart[chunk * ch + 2 * pr + 1] = a1;
    }
    __syncthreads();
    const float inv_grid = 1.f / (float)(N - 1);
    for (int i = tid; i < ch; i += kThreads) {
      float a = 0.f;
      for (int k = 0; k < P; ++k) a += gpart[k * ch + i];
      const int c = c0 + i;
      gap[i] = fmaf(__ldg(vec + kLnxW * C + c), a * inv_grid,
                    __ldg(vec + kLnxB * C + c));
    }
  }
  cluster_sync();
  const int pad = (ktap - 1) / 2;
  for (int i = tid; i < ch; i += kThreads) {
    const int c = c0 + i;
    float q = 0.f, k = 0.f;
    for (int j = 0; j < ktap; ++j) {
      const int cc = c + j - pad;
      if (cc >= 0 && cc < C) {
        const float g = cluster_value(cluster, gap, cc, ch, rank);
        q = fmaf(__ldg(taps + j), g, q);
        k = fmaf(__ldg(taps + ktap + j), g, k);
      }
    }
    qk[i] = q * k;
  }
  cluster_sync();
  {
    const float scale = 1.f / sqrtf((float)d);
    for (int i = tid; i < ch; i += kThreads) {
      const int h0 = (c0 + i) / d * d;  // first channel of this head
      float s = 0.f;
      for (int j = 0; j < d; ++j)
        s += cluster_value(cluster, qk, h0 + j, ch, rank);
      gate[i] = 1.f / (1.f + expf(-s * scale));
    }
  }
  // No block may leave while another still reads its shared memory: arrive
  // now, wait at the end.
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  __syncthreads();

  // 4. finish.  Items: the cls row's vectors, then segments of pairs of
  // grid rows, a thread walking one segment of two rows for one 4-channel
  // vector with the 4 x 3 window of normx in registers (one new column of
  // four rows for two pixels, zero outside the grid).
  {
    constexpr int V = 4;
    const int vecs = ch / V;
    const int pairs = (S + 1) / 2;  // of grid rows
    const int seg = S >= 8 ? (S + 1) / 2 : S;
    const int segs = (S + seg - 1) / seg;
    const int items = vecs * (1 + pairs * segs);
    for (int item = tid; item < items; item += kThreads) {
      const int v = item % vecs;
      const int rest = item / vecs;
      const int cl = v * V;
      const int c = c0 + cl;
      auto ld4 = [&](int row, float f[V]) {
        const float4 a =
            __ldg(reinterpret_cast<const float4*>(vec + row * C + c));
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      };
      auto unpack4 = [](uint2 raw, float f[V]) {
        f[0] = __uint_as_float(raw.x << 16);
        f[1] = __uint_as_float(raw.x & 0xffff0000u);
        f[2] = __uint_as_float(raw.y << 16);
        f[3] = __uint_as_float(raw.y & 0xffff0000u);
      };
      auto load4 = [&](int r, float f[V]) {
        unpack4(*reinterpret_cast<const uint2*>(xs + (size_t)r * ch + cl), f);
      };
      auto store4 = [&](int r, const float y[V]) {
        *reinterpret_cast<uint2*>(out + (row0 + r) * C + c) =
            make_uint2(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]));
      };
      float wx[V], bx[V];
      ld4(kLnxW, wx);
      ld4(kLnxB, bx);
      if (rest == 0) {
        // the cls row: x + LN_x(x); no MRLA term and no dependence on ot
        float xv[V], y[V];
        load4(0, xv);
        const float2 s0 = stx[0];
#pragma unroll
        for (int j = 0; j < V; ++j)
          y[j] = xv[j] + fmaf(fmaf(xv[j], s0.x, s0.y), wx[j], bx[j]);
        store4(0, y);
        continue;
      }
      const int hp = (rest - 1) / segs;
      const int h = 2 * hp;  // rows h and h + 1 (if h + 1 < S)
      const int w0 = (rest - 1 - hp * segs) * seg;
      const int w1 = min(w0 + seg, S);
      const bool two = h + 1 < S;
      float wv[9][V], wo[V], bo[V], lam[V], g[V];
#pragma unroll
      for (int t = 0; t < 9; ++t) ld4(kWv + t, wv[t]);
      ld4(kLnoW, wo);
      ld4(kLnoB, bo);
      ld4(kLam, lam);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = gate[cl + j];
      // normx of grid column ww, rows h - 1 .. h + 2
      auto column = [&](int ww, float col[4][V]) {
        const bool in = ww >= 0 && ww < S;
#pragma unroll
        for (int dr = 0; dr < 4; ++dr) {
          const int hh = h + dr - 1;
          if (!in || hh < 0 || hh >= S) {
#pragma unroll
            for (int j = 0; j < V; ++j) col[dr][j] = 0.f;
          } else {
            const int r = 1 + hh * S + ww;
            float n[V];
            load4(r, n);
            const float2 s = stx[r];
#pragma unroll
            for (int j = 0; j < V; ++j)
              col[dr][j] = fmaf(fmaf(n[j], s.x, s.y), wx[j], bx[j]);
          }
        }
      };
      // out of grid pixel (hh, w), the window's rows top .. top + 2
      auto finish = [&](float win[3][4][V], int top, int hh, int w) {
        const int r = 1 + hh * S + w;
        float xv[V], ov[V], y[V];
        load4(r, xv);
        unpack4(__ldg(reinterpret_cast<const uint2*>(ot + (row0 + r) * C + c)),
                ov);
        const float2 so = sto[r];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float a = 0.f;
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
              a = fmaf(win[dw][top + dh][j], wv[dh * 3 + dw][j], a);
          const float no = fmaf(fmaf(ov[j], so.x, so.y), wo[j], bo[j]);
          y[j] = xv[j] + fmaf(gelu_erf(a), g[j], lam[j] * no);
        }
        store4(r, y);
      };
      float win[3][4][V];  // [column w - 1 .. w + 1][row h - 1 .. h + 2]
      column(w0 - 1, win[0]);
      column(w0, win[1]);
      for (int w = w0; w < w1; ++w) {
        column(w + 1, win[2]);
        finish(win, 0, h, w);
        if (two) finish(win, 1, h + 1, w);
#pragma unroll
        for (int dr = 0; dr < 4; ++dr)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            win[0][dr][j] = win[1][dr][j];
            win[1][dr][j] = win[2][dr][j];
          }
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the side of the square grid behind N - 1 rows, or 0
int grid_side(int N) {
  if (N < 2) return 0;
  int s = (int)lround(sqrt((double)(N - 1)));
  return s * s == N - 1 ? s : 0;
}

bool slice_ok(int N, int C, int cs) {
  return C % cs == 0 && (C / cs) % 8 == 0 && tail_smem(N, C / cs) <= kMaxSmem;
}

bool supported(int N, int C, int d, int ktap) {
  if (grid_side(N) == 0 || C <= 0 || C % 32 || C > 1024 || d <= 0 || C % d ||
      ktap < 1 || ktap % 2 == 0)
    return false;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2)
    if (slice_ok(N, C, cs)) return true;
  return false;
}

// Lets the kernel take `smem` bytes of dynamic shared memory and clusters of
// 16 on the current device; cudaFuncSetAttribute runs once per device.
cudaError_t allow_kernel() {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(deit_tail_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(deit_tail_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) allowed[dev] = true;
  return err;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B,
                   int cs, size_t smem, cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cs, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Clusters of cs blocks at shape (N, C) the current device holds at once
// (cudaOccupancyMaxActiveClusters, remembered per device and shape), or a
// negative cudaError.
int clusters_at_once(int N, int C, int cs) {
  struct Entry { int dev, N, C, cs, n; };
  static std::mutex mu;
  static Entry seen[64];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < count; ++i)
      if (seen[i].dev == dev && seen[i].N == N && seen[i].C == C &&
          seen[i].cs == cs)
        return seen[i].n;
  }
  if ((err = allow_kernel()) != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, 1, cs, tail_smem(N, C / cs), nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, deit_tail_cluster_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (count < 64) seen[count++] = Entry{dev, N, C, cs, n};
  return n;
}

// The rule: among the cluster sizes whose slices fit a block, the one whose
// B images take the least rounds of co-resident clusters times channels a
// block (the work a block does serially); the smaller on a tie.  *cs = 0
// if none fits; the return value is a cudaError.
int pick_cluster(int B, int N, int C, int* cs) {
  *cs = 0;
  long long best = 0;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    if (!slice_ok(N, C, c)) continue;
    const int n = clusters_at_once(N, C, c);
    if (n < 0) return -n;
    if (n == 0) continue;
    const long long cost = (long long)((B + n - 1) / n) * (C / c);
    if (*cs == 0 || cost < best) {
      *cs = c;
      best = cost;
    }
  }
  return (int)cudaSuccess;
}

// cs == 0: the rule's; otherwise cs itself, if its slices fit (else 0).
int resolve_cluster(int B, int N, int C, int* cs) {
  if (*cs == 0) return pick_cluster(B, N, C, cs);
  if (*cs < 1 || *cs > kMaxCluster || (*cs & (*cs - 1)) ||
      !slice_ok(N, C, *cs))
    *cs = 0;
  return (int)cudaSuccess;
}

}  // namespace

// What a launch at this shape runs: out[0] the cluster size (0 for shapes the
// kernel does not take), out[1] a block's shared memory in bytes, out[2]
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] the
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).  cs as
// for tune_deit_tail_cluster_bf16.
extern "C" int tune_deit_tail_cluster_describe(int B, int N, int C, int d,
                                               int ktap, int cs, int* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
  if (B < 1 || !supported(N, C, d, ktap)) return (int)cudaSuccess;
  int err = resolve_cluster(B, N, C, &cs);
  if (err != cudaSuccess || cs == 0) return err;
  const size_t smem = tail_smem(N, C / cs);
  out[0] = cs;
  out[1] = (int)smem;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], deit_tail_cluster_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[3] = clusters_at_once(N, C, cs);
  return out[3] < 0 ? -out[3] : (int)cudaSuccess;
}

// x, ot, out: [B, N, C] bf16, N - 1 a square; vec: [14, C] fp32 (rows: LN_x
// weight, bias; LN_o weight, bias; lam; the nine depthwise taps in
// (dh + 1) * 3 + (dw + 1) order); taps: [2, ktap] fp32.  cs: the cluster
// size, 0 for the rule's (a power of two up to 16 whose C / cs channels are
// a multiple of 8 and fit a block).  Takes C % 32 == 0, C <= 1024, an image
// whose slices fit a block at some cluster size, heads of d channels with
// C % d == 0 and an odd ktap; anything else is cudaErrorInvalidValue.
extern "C" int tune_deit_tail_cluster_bf16(const void* x, const void* ot,
                                           const void* vec, const void* taps,
                                           void* out, int B, int N, int C,
                                           int d, int ktap, int cs,
                                           void* stream) {
  if (B < 0 || B > 65535 || !supported(N, C, d, ktap))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int err = resolve_cluster(B, N, C, &cs);
  if (err != cudaSuccess) return err;
  if (cs == 0) return (int)cudaErrorInvalidValue;
  if ((err = (int)allow_kernel()) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, B, cs, tail_smem(N, C / cs),
                static_cast<cudaStream_t>(stream));
  err = (int)cudaLaunchKernelEx(
      &cfg, deit_tail_cluster_kernel, static_cast<const bf16*>(x),
      static_cast<const bf16*>(ot), static_cast<const float*>(vec),
      static_cast<const float*>(taps), static_cast<bf16*>(out), N,
      grid_side(N), C, d, ktap);
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}
