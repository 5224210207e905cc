// A design of the DeiT MRLA-light token tail that was on the path and was
// replaced: three launches (stats, gate, main) behind one C entry point.
// The library's kernel (csrc/deit_token_tail.cu, two passes) took its
// place; tune_deit_tail.py builds this file on its own and times it, whole
// and a launch at a time (tune_deit_tail_launches_phase), beside the
// library's.  It is on no path.
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
// Bound on an H100: memory.  x and ot are read and out is written once,
// 6 bytes an element for about 60 fp32 operations, far below the card's
// balance point: [128, 197, 384] is 58.1 MB, 0.0173 ms at 3.35 TB/s.
//
// Design.  The mean over the image's grid rows must be known before any
// grid row can be finished, and one image (197 * C * 2 bytes, 303 KB at
// C = 768) does not fit a block's shared memory at every width.  So the
// barrier is the kernel boundary: three launches behind one C entry point.
//   1. stats: a warp per row takes the mean and rstd (two passes over
//      registers: mean, then mean((x - mean)^2)) of the row of x and of ot,
//      both rows loaded together, and adds a grid row's normx to per-lane
//      channel sums; a block of 32 rows of one image writes its partial
//      channel sums.  No atomics: the result does not change from run to
//      run.
//   2. gate: a block per image sums the partial sums, runs the two channel
//      convolutions, sums each head's q * k in fp32 and writes the [B, C]
//      gate.
//   3. main: a block per image and 32 channels.  It stages its [N, 32]
//      slices of x and ot in shared memory with 16-byte loads, several rows
//      in flight per thread, and normalises x once into shared memory as
//      well (fp32; 51 KB in all at N = 197), so normx never reaches device
//      memory and no neighbour is normalised nine times; then a thread per
//      2 channels walks the rows, reads the nine neighbours from shared
//      memory (zero outside the S x S grid, so never the cls row or
//      another image) and finishes the row in place; the block writes out
//      with 16-byte stores.
// Device memory sees x twice (the second time mostly from L2), ot twice
// and out once; the scratch (statistics 16 bytes a row, partial sums and
// the gate) is a few hundred KB.
#include <math.h>

#include <mutex>

#include "mrla_tail.cuh"

namespace {

constexpr int kWarps = 8;          // warps of a stats block
constexpr int kRowsPerBlock = 32;  // rows of one image per stats block
constexpr int kMaxVec = 4;         // 8-channel vectors a lane holds: C <= 1024
constexpr int kThreads = 256;
constexpr int kCh = 32;            // channels of a main block
constexpr int kUnroll = 4;         // rows a main thread has in flight
constexpr size_t kMaxSmem = 232448;  // what a block may have on sm_90
constexpr float kEps = 1e-6f;

// rows of the packed [14, C] fp32 parameter array
constexpr int kLnxW = 0, kLnxB = 1, kLnoW = 2, kLnoB = 3, kLam = 4, kWv = 5;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A row of C values spread over a warp: lane l holds the 8-channel vectors
// l, l + 32, ... (those below `vecs`) in r[0], r[1], ...
template <int NV>
__device__ __forceinline__ void load_row(const bf16* row, int lane, int vecs,
                                         float r[NV][8]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < vecs)
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(row) + v), r[i]);
  }
}

// (mean, rstd) of such a row: the variance is mean((x - mean)^2).
template <int NV>
__device__ __forceinline__ float2 row_stats(float r[NV][8], int lane,
                                            int vecs, float inv_c) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s += r[i][j];
    }
  const float mean = warp_sum(s) * inv_c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = r[i][j] - mean;
        q = fmaf(d, d, q);
      }
    }
  return make_float2(mean, rsqrtf(warp_sum(q) * inv_c + kEps));
}

// Phase 1.  grid (chunks, B); block kWarps warps; dynamic shared memory
// kWarps * C floats; NV = the 8-channel vectors a lane holds, C <= 256 * NV.
// sx, so: (mean, rstd) of every row of x and of ot; part[b][chunk][c]: the
// sum of normx[c] over the chunk's grid rows.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    deit_tail_stats_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ ot,
                           const float* __restrict__ vec,
                           float2* __restrict__ sx, float2* __restrict__ so,
                           float* __restrict__ part, int N, int C) {
  extern __shared__ float acc[];  // [kWarps][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int vecs = C / 8;
  const float inv_c = 1.f / (float)C;

  float sum[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum[i][j] = 0.f;

  const int r0 = chunk * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, N);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int64_t row = (int64_t)b * N + r;
    float v[NV][8], o[NV][8];
    load_row<NV>(x + row * C, lane, vecs, v);
    load_row<NV>(ot + row * C, lane, vecs, o);
    const float2 st = row_stats<NV>(v, lane, vecs, inv_c);
    const float2 sto = row_stats<NV>(o, lane, vecs, inv_c);
    if (lane == 0) {
      sx[row] = st;
      so[row] = sto;
    }
    if (r > 0) {  // a grid row: its normx goes into the image's mean
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c0 = (lane + 32 * i) * 8;
        if (c0 < C) {
          float w[8], bi[8];
          load_f8(vec + kLnxW * C + c0, w);
          load_f8(vec + kLnxB * C + c0, bi);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum[i][j] += (v[i][j] - st.x) * st.y * w[j] + bi[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (lane + 32 * i) * 8;
    if (c0 < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[warp * C + c0 + j] = sum[i][j];
    }
  }
  __syncthreads();
  float* dst = part + ((int64_t)b * gridDim.x + chunk) * C;
  for (int c = threadIdx.x; c < C; c += kWarps * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * C + c];
    dst[c] = s;
  }
}

template <int NV>
cudaError_t launch_stats(const bf16* x, const bf16* ot, const float* vec,
                         float2* sx, float2* so, float* part, int chunks,
                         int B, int N, int C, cudaStream_t s) {
  deit_tail_stats_kernel<NV><<<dim3(chunks, B), kWarps * 32,
                               kWarps * C * sizeof(float), s>>>(
      x, ot, vec, sx, so, part, N, C);
  return cudaGetLastError();
}

// Phase 2.  grid B; dynamic shared memory 2 * C floats.  taps: [2, ktap],
// wq then wk; tap j reads channel c + j - (ktap - 1) / 2, zero outside [0, C).
__global__ void __launch_bounds__(kThreads)
    deit_tail_gate_kernel(const float* __restrict__ part,
                          const float* __restrict__ taps,
                          float* __restrict__ gate, int chunks, int N, int C,
                          int d, int ktap) {
  extern __shared__ float sm[];
  float* gap = sm;
  float* qk = sm + C;
  const int b = blockIdx.x;
  const float* src = part + (int64_t)b * chunks * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int i = 0; i < chunks; ++i) s += src[i * C + c];
    gap[c] = s / (float)(N - 1);
  }
  __syncthreads();
  const int pad = (ktap - 1) / 2;
  for (int c = threadIdx.x; c < C; c += kThreads) {
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
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int h0 = c / d * d;  // first channel of this channel's head
    float s = 0.f;
    for (int i = 0; i < d; ++i) s += qk[h0 + i];
    gate[(int64_t)b * C + c] = 1.f / (1.f + expf(-s * scale));
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

// Shared memory of a main block, in bytes: normx fp32 [N][kCh], then x
// (later out) and ot bf16 [N][kCh], then ot's statistics float2 [N].
__host__ __device__ constexpr size_t main_smem(int N) {
  return (size_t)N * (kCh * 4 + 2 * kCh * 2 + 8);
}

// Phase 3.  grid (C / kCh, B); block kThreads; dynamic shared memory
// main_smem(N).  Three steps: stage the image's rows of channels c0 ..
// c0 + kCh (16-byte loads, kUnroll rows in flight per thread), finish every
// row from shared memory alone, write out with 16-byte stores.
__global__ void __launch_bounds__(kThreads)
    deit_tail_main_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ ot,
                          const float* __restrict__ vec,
                          const float2* __restrict__ sx,
                          const float2* __restrict__ so,
                          const float* __restrict__ gate,
                          bf16* __restrict__ out, int N, int S, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* nx = reinterpret_cast<float*>(smem_raw);              // [N][kCh]
  bf16* xs = reinterpret_cast<bf16*>(nx + (size_t)N * kCh);    // [N][kCh]
  bf16* os = xs + (size_t)N * kCh;                             // [N][kCh]
  float2* sos = reinterpret_cast<float2*>(os + (size_t)N * kCh);  // [N]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCh;
  const int64_t row0 = (int64_t)blockIdx.y * N;
  constexpr int kRows = kThreads / 4;  // rows a pass of the block covers
  const int v8 = (tid & 3) * 8;  // thread -> 8 channels of rows tid / 4, ..

  {
    float w[8], bi[8];
    load_f8(vec + kLnxW * C + c0 + v8, w);
    load_f8(vec + kLnxB * C + c0 + v8, bi);
    for (int ra = tid >> 2; ra < N; ra += kUnroll * kRows) {
      uint4 xraw[kUnroll], oraw[kUnroll];
      float2 st[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = ra + u * kRows;
        if (r < N) {
          const int64_t at = (row0 + r) * C + c0 + v8;
          xraw[u] = __ldg(reinterpret_cast<const uint4*>(x + at));
          oraw[u] = __ldg(reinterpret_cast<const uint4*>(ot + at));
          st[u] = __ldg(sx + row0 + r);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = ra + u * kRows;
        if (r < N) {
          float xv[8], y[8];
          bf16x8_to_float(xraw[u], xv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            y[j] = (xv[j] - st[u].x) * st[u].y * w[j] + bi[j];
          float4* dst = reinterpret_cast<float4*>(nx + r * kCh + v8);
          dst[0] = make_float4(y[0], y[1], y[2], y[3]);
          dst[1] = make_float4(y[4], y[5], y[6], y[7]);
          *reinterpret_cast<uint4*>(xs + r * kCh + v8) = xraw[u];
          *reinterpret_cast<uint4*>(os + r * kCh + v8) = oraw[u];
        }
      }
    }
    for (int r = tid; r < N; r += kThreads) sos[r] = __ldg(so + row0 + r);
  }
  __syncthreads();

  {  // finish: thread -> channels cl, cl + 1 of rows tid / 16, + 16, ..
    const int cl = (tid & 15) * 2;  // within the block's kCh channels
    const int c = c0 + cl;
    float2 tap[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      tap[i] = __ldg(reinterpret_cast<const float2*>(vec + (kWv + i) * C + c));
    const float2 wo =
        __ldg(reinterpret_cast<const float2*>(vec + kLnoW * C + c));
    const float2 bo =
        __ldg(reinterpret_cast<const float2*>(vec + kLnoB * C + c));
    const float2 lam =
        __ldg(reinterpret_cast<const float2*>(vec + kLam * C + c));
    const float2 g = __ldg(
        reinterpret_cast<const float2*>(gate + (int64_t)blockIdx.y * C + c));
    const float inv_s = 1.f / (float)S;

    for (int r = tid >> 4; r < N; r += kThreads / 16) {
      __nv_bfloat162* xo =
          reinterpret_cast<__nv_bfloat162*>(xs + r * kCh + cl);
      const float2 xf = __bfloat1622float2(*xo);
      const float2 n0 = *reinterpret_cast<const float2*>(nx + r * kCh + cl);
      if (r == 0) {
        // the cls row: x + LN_x(x); no MRLA term and no dependence on ot
        *xo = __floats2bfloat162_rn(xf.x + n0.x, xf.y + n0.y);
        continue;
      }
      const int t = r - 1;
      // t / S: (t + 0.5) / S is at least 0.5 / S away from an integer
      const int h = (int)(((float)t + 0.5f) * inv_s), wcol = t - h * S;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int dh = -1; dh <= 1; ++dh) {
        if (h + dh < 0 || h + dh >= S) continue;
#pragma unroll
        for (int dw = -1; dw <= 1; ++dw) {
          if (wcol + dw < 0 || wcol + dw >= S) continue;
          const float2 n = *reinterpret_cast<const float2*>(
              nx + (r + dh * S + dw) * kCh + cl);
          const float2 tp = tap[(dh + 1) * 3 + (dw + 1)];
          acc.x = fmaf(n.x, tp.x, acc.x);
          acc.y = fmaf(n.y, tp.y, acc.y);
        }
      }
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(os + r * kCh + cl));
      const float2 st = sos[r];
      const float no0 = (of.x - st.x) * st.y * wo.x + bo.x;
      const float no1 = (of.y - st.x) * st.y * wo.y + bo.y;
      *xo = __floats2bfloat162_rn(xf.x + gelu_erf(acc.x) * g.x + lam.x * no0,
                                  xf.y + gelu_erf(acc.y) * g.y + lam.y * no1);
    }
  }
  __syncthreads();

  for (int r = tid >> 2; r < N; r += kRows)  // out, as it was staged
    *reinterpret_cast<uint4*>(out + (row0 + r) * C + c0 + v8) =
        *reinterpret_cast<const uint4*>(xs + r * kCh + v8);
}

// Lets the main kernel take `smem` bytes of dynamic shared memory on the
// current device; cudaFuncSetAttribute runs only when a launch needs more
// than was allowed so far.
cudaError_t allow_main_smem(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static size_t allowed[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(deit_tail_main_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

int chunks_of(int N) { return (N + kRowsPerBlock - 1) / kRowsPerBlock; }

// the side of the square grid behind N - 1 rows, or 0
int grid_side(int N) {
  if (N < 2) return 0;
  int s = (int)lround(sqrt((double)(N - 1)));
  return s * s == N - 1 ? s : 0;
}

bool supported(int N, int C, int d, int ktap) {
  return grid_side(N) > 0 && main_smem(N) <= kMaxSmem &&
         C > 0 && C % kCh == 0 && C <= 8 * 32 * kMaxVec && d > 0 &&
         C % d == 0 && ktap >= 1 && ktap % 2 == 1;
}

}  // namespace

// The fp32 values of scratch the launch needs for each image (the gate, the
// partial channel sums and the rows' statistics), or -1 for shapes the kernel
// does not take.
extern "C" int tune_deit_tail_launches_scratch_per_image(int N, int C,
                                                         int d, int ktap) {
  if (!supported(N, C, d, ktap)) return -1;
  return C + chunks_of(N) * C + 4 * N;
}

// x, ot, out: [B, N, C] bf16, N - 1 a square; vec: [14, C] fp32 (rows: LN_x
// weight, bias; LN_o weight, bias; lam; the nine depthwise taps in
// (dh + 1) * 3 + (dw + 1) order); taps: [2, ktap] fp32; scratch: B times
// tune_deit_tail_launches_scratch_per_image fp32 values.  phase: -1 all
// three launches, 0 the stats, 1 the gate, 2 the main launch alone (each of
// the last two reads what the launches before it left in scratch).  Takes
// C % 32 == 0, C <= 1024, N <= 880 (an image's 32-channel slices in shared
// memory), heads of d channels with C % d == 0 and an odd ktap; anything
// else is cudaErrorInvalidValue.
extern "C" int tune_deit_tail_launches_phase(const void* x, const void* ot,
                                             const void* vec,
                                             const void* taps, void* scratch,
                                             void* out, int B, int N, int C,
                                             int d, int ktap, int phase,
                                             void* stream) {
  if (B < 0 || B > 65535 || !supported(N, C, d, ktap))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = chunks_of(N);
  const int64_t rows = (int64_t)B * N;
  float* gate = static_cast<float*>(scratch);
  float* part = gate + (int64_t)B * C;
  float2* sx = reinterpret_cast<float2*>(part + (int64_t)B * chunks * C);
  float2* so = sx + rows;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ob = static_cast<const bf16*>(ot);
  const float* fvec = static_cast<const float*>(vec);
  cudaError_t err;

  auto stats = launch_stats<kMaxVec>;
  switch ((C / 8 + 31) / 32) {  // 8-channel vectors a lane holds
    case 1: stats = launch_stats<1>; break;
    case 2: stats = launch_stats<2>; break;
    case 3: stats = launch_stats<3>; break;
  }
  if (phase == -1 || phase == 0) {
    err = stats(xb, ob, fvec, sx, so, part, chunks, B, N, C, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (phase == -1 || phase == 1) {
    deit_tail_gate_kernel<<<B, kThreads, 2 * C * sizeof(float), s>>>(
        part, static_cast<const float*>(taps), gate, chunks, N, C, d, ktap);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phase != -1 && phase != 2) return (int)cudaSuccess;
  const size_t smem = main_smem(N);
  if ((err = allow_main_smem(smem)) != cudaSuccess) return (int)err;
  deit_tail_main_kernel<<<dim3(C / kCh, B), kThreads, smem, s>>>(
      xb, ob, fvec, sx, so, gate, static_cast<bf16*>(out), N, grid_side(N),
      C);
  return (int)cudaGetLastError();
}

// Each launch at [., N, C] as the card runs it: out[5 k .. 5 k + 4] for
// launch k (0 stats, 1 gate, 2 main) holds registers a thread, local
// (spilled) bytes a thread, static and dynamic shared memory bytes a
// block, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int tune_deit_tail_launches_describe(int N, int C, int* out) {
  if (!supported(N, C, 16, 5)) return (int)cudaErrorInvalidValue;
  const void* fns[3] = {nullptr, (const void*)deit_tail_gate_kernel,
                        (const void*)deit_tail_main_kernel};
  switch ((C / 8 + 31) / 32) {
    case 1: fns[0] = (const void*)deit_tail_stats_kernel<1>; break;
    case 2: fns[0] = (const void*)deit_tail_stats_kernel<2>; break;
    case 3: fns[0] = (const void*)deit_tail_stats_kernel<3>; break;
    default: fns[0] = (const void*)deit_tail_stats_kernel<kMaxVec>; break;
  }
  const int threads[3] = {kWarps * 32, kThreads, kThreads};
  const size_t dyn[3] = {kWarps * C * sizeof(float), 2 * C * sizeof(float),
                         main_smem(N)};
  cudaError_t err = allow_main_smem(main_smem(N));
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes at;
    if ((err = cudaFuncGetAttributes(&at, fns[k])) != cudaSuccess)
      return (int)err;
    int* o = out + 5 * k;
    o[0] = at.numRegs;
    o[1] = (int)at.localSizeBytes;
    o[2] = (int)at.sharedSizeBytes;
    o[3] = (int)dyn[k];
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &o[4], fns[k], threads[k], dyn[k])) != cudaSuccess)
      return (int)err;
  }
  return (int)cudaSuccess;
}
