// The last stage of resnet50_mrlal after layer4_0's conv2, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/mrla_stage4.py (stage4_resident ->
// _kernel).  From ob = relu(conv2(relu(conv1(x)))) [B, 7, 7, C1] and the
// strided stage input xs = x[:, ::2, ::2, :] [B, 7, 7, CIN] of layer4_0 it
// computes the stage output [B, 7, 7, C]; rows are the B * 49 pixels:
//
//     id0 = xs @ kd + bd ; z0 = ob @ k3_0 + b3_0 ; y = tail(relu(z0 + id0), id0)
//     for blk in 1, 2:
//         x1 = relu(y @ k1 + b1)                    [rows, C1], rounded to bf16
//         o  = relu(conv3x3(x1, k2) + b2)           [rows, C1], rounded to bf16
//         z  = o @ k3 + b3
//         y  = tail(relu(z + y), y)                 y stays fp32 between blocks
//     tail(out, id): gap  = mean of out over the image's 49 pixels
//                    q, k = ktap-tap convs of gap along the channels
//                    gate = sigmoid(sum over a head's channels of q*k / sqrt(d))
//                    out + (dwconv3x3(out) * gate + lam * id) * bn_scale + bn_bias
//
// Products take bf16 operands and sum in fp32; z, id0, out and y are fp32;
// the last y is rounded to bf16 once.
//
// Bound on an H100: operations.  At the published widths (CIN 1024, C1 512,
// C 2048, 64 heads) and batch 128 the products are 151 GFLOP, 0.153 ms at
// the 989 TFLOP/s bf16 tensor-core peak, while the bytes that must cross
// device memory (24 MB of weights, ob, xs, the output) are 69 MB, 0.021 ms
// at 3.35 TB/s.
//
// Design: a fixed sequence of kernels behind one C entry point, with the
// intermediates in scratch memory that the caller allocates.  The weights
// (24 MB) do not fit a block's 227 KB of shared memory but do fit the 50 MB
// L2, and the gate needs the mean over a whole image and all C channels
// before any pixel of the tail can be finished, three times.  A block that
// owned whole images would have to stream all 24 MB for 49 rows of work;
// instead each product is tiled over all SMs and the barrier before each
// gate is the kernel boundary:
//
//   * stage4_gemm_kernel: out[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias),
//     a 64 x 128 tile per block of one warpgroup.  K moves in chunks of 64
//     through a 3-deep cp.async ring in shared memory, laid out in the
//     128-byte swizzle that wgmma reads, and the warpgroup issues wgmma
//     m64n128k16 (bf16 in, fp32 accumulate) with both operands from shared
//     memory; the next chunk's copies start while this chunk's products
//     run, and three blocks share an SM.  A's rows are addressed as pixels
//     through (image, row, column) strides, so xs is read in place from the
//     parent map, and the 3x3 convolution is the same kernel with
//     K = 9 * C1: chunk k belongs to tap k / C1 and reads the pixel shifted
//     by that tap, zero-filled outside the pixel's own 7 x 7 image.
//     Epilogues, through a tile in shared memory so that global memory sees
//     whole rows: bf16 relu (x1, o); fp32 (id0); fp32 relu(acc + bias + res)
//     (out, with res = id0 or the previous y).
//   * stage4_tail_kernel: one block per image and 128 channels.  It stages
//     its [49, 128 + halo] slice of out (fp32) in shared memory, reduces the
//     GAP, computes q, k, the head sums in fp32 and the gate, then the
//     depthwise 3x3 from shared memory, and writes y as fp32 (over id, which
//     only this thread reads) and as bf16 (the next product's operand, or
//     the stage's output).
//
// No library computes any product: no cuBLAS, no cuDNN, no CUTLASS device
// GEMM.  Eleven launches a call.
#include <mutex>

#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

constexpr int kHW = 7;          // the stage's map is 7 x 7
constexpr int kSP = kHW * kHW;  // pixels per image
constexpr int kThreads = 128;   // one warpgroup
constexpr int kBN = 128;        // output columns per block
constexpr int kBM = 64;         // rows per block: one wgmma tile; three
                                // blocks share an SM
constexpr int kBK = 64;         // K chunk: one 128-byte row of bf16
constexpr int kRow = 128;       // bytes of a tile row in shared memory
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kLdC = kBN + 8;   // fp32 row stride of the epilogue's tile

enum Epilogue { kBf16Relu = 0, kF32 = 1, kF32ResRelu = 2 };

struct GemmArgs {
  const __nv_bfloat16* A;  // pixel (img, h, w) at img * sB + h * sH + w * sW
  int64_t sB, sH, sW;      // strides in elements; channels are contiguous
  const __nv_bfloat16* W;  // [N, K], K contiguous
  const float* bias;       // [N]
  const float* res;        // [M, N] fp32, kF32ResRelu only
  void* out;               // [M, N] bf16 or fp32
  int M, N, K;
  int Kt;                  // K per tap: K for a 1x1 product, K / 9 for the 3x3
};

// d[64 x 128] += A[64 x 16] @ B[128 x 16]^T, both operands from shared
// memory, asynchronously; d is this thread's 64 values of the warpgroup's
// tile (rows 16 * warp + lane / 4 and + 8, columns 8 j + 2 * (lane % 4)).
__device__ __forceinline__ void wgmma_64x128x16(float d[64], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));  // p: accumulate onto d
}

// Dynamic shared memory of a block: the ring (plus room to align it to 1024
// bytes), reused for the fp32 tile.
constexpr size_t kRingBytes = (size_t)kStages * (kBM + kBN) * kRow;
constexpr size_t kTileBytes = sizeof(float) * kBM * kLdC;
constexpr size_t kSmemBytes =
    (kRingBytes > kTileBytes ? kRingBytes : kTileBytes) + 1024;

template <int EPI>
__global__ void __launch_bounds__(kThreads) stage4_gemm_kernel(GemmArgs g) {
  constexpr int BM = kBM;  // tile rows
  constexpr int CPR = kBK / 8;         // 16-byte chunks per tile row
  constexpr int RPP = kThreads / CPR;  // tile rows the block copies per pass
  static_assert(BM % RPP == 0 && kBN % RPP == 0, "tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* As = smem;                        // [kStages][BM][kRow]
  unsigned char* Bs = smem + kStages * BM * kRow;  // [kStages][kBN][kRow]
  // per tile row: its pixel's offset in A and (h << 8 | w), -1 past M
  __shared__ int64_t row_off[BM];
  __shared__ int row_hw[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bm0 = blockIdx.y * BM;
  const int bn0 = blockIdx.x * kBN;

  for (int i = tid; i < BM; i += kThreads) {
    const int r = bm0 + i;
    const int img = r / kSP;
    const int p = r % kSP;
    const int h = p / kHW;
    const int w = p % kHW;
    row_off[i] = img * g.sB + h * g.sH + w * g.sW;
    row_hw[i] = r < g.M ? (h << 8 | w) : -1;
  }
  __syncthreads();

  // What this thread copies: chunk ld_c (8 values) of rows ld_row + RPP * i;
  // RPP is a multiple of 8, so the swizzled place of the chunk is the same
  // in each of those rows.
  const int ld_row = tid / CPR;
  const int ld_c = tid % CPR;
  const int ld_dst = ld_row * kRow + ((ld_c ^ (ld_row & 7)) << 4);
  const bool conv = g.Kt != g.K;

  // Chunk kt of K.  For the 3x3, W's columns are tap-major (tap * Kt +
  // channel) and a chunk never straddles two taps: it reads A's pixels
  // shifted by its tap.
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kBK + ld_c * 8;  // column of W
    const int tap = k0 / g.Kt;
    const int dh = conv ? tap / 3 - 1 : 0;
    const int dw = conv ? tap % 3 - 1 : 0;
    const int64_t shift = dh * g.sH + dw * g.sW + (k0 - tap * g.Kt);
    unsigned char* as = As + stage * BM * kRow + ld_dst;
    unsigned char* bs = Bs + stage * kBN * kRow + ld_dst;
#pragma unroll
    for (int i = 0; i < BM / RPP; ++i) {
      const int row = ld_row + RPP * i;
      const int hw = row_hw[row];
      // rows past M and taps outside the pixel's own image are zero-filled
      const bool ok = hw >= 0 && (unsigned)((hw >> 8) + dh) < (unsigned)kHW &&
                      (unsigned)((hw & 255) + dw) < (unsigned)kHW;
      cp_async16(as + RPP * i * kRow, ok ? g.A + row_off[row] + shift : g.A,
                 ok);
    }
    const __nv_bfloat16* wsrc = g.W + (int64_t)(bn0 + ld_row) * g.K + k0;
#pragma unroll
    for (int i = 0; i < kBN / RPP; ++i)
      cp_async16(bs + RPP * i * kRow, wsrc + (int64_t)RPP * i * g.K, true);
  };

  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;

  const int KT = g.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's part of chunk kt landed
    // make it visible to the tensor cores' reads of shared memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();               // and everyone's
    const uint64_t da = wgmma_desc(As + (kt % kStages) * BM * kRow);
    const uint64_t db = wgmma_desc(Bs + (kt % kStages) * kBN * kRow);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_64x128x16(acc, da + ((ks * 32) >> 4), db + ((ks * 32) >> 4));
    wgmma_commit();
    // chunk kt - 1's products are done (this chunk's may still run), so
    // its stage can take chunk kt + kStages - 1
    wgmma_wait<1>();
    if (kt + kStages - 1 < KT)
      load_tile((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 64; ++j)
    asm volatile("" : "+f"(acc[j])::"memory");  // read only from here on
  __syncthreads();  // every warp is done with the ring, which is reused

  // The tile goes through shared memory so that a warp reads res and writes
  // out as whole rows of the tile (512 contiguous bytes), several rows in
  // flight, rather than as the fragments' scattered 8-byte pieces.
  constexpr int LDC = kLdC;  // 8 past the tile: conflict-free fragments
  float* Cs = reinterpret_cast<float*>(smem);
  const int gq = lane >> 2;  // fragment row
  const int tq = lane & 3;   // column pair
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(Cs + (warp * 16 + gq + half * 8) * LDC +
                                 j * 8 + 2 * tq) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  __syncthreads();

  constexpr int V = kBN / 4;          // float4 per tile row
  constexpr int RPI = kThreads / V;   // tile rows per pass of the block
  constexpr int U = 4;                // passes whose loads are in flight
  static_assert(BM % (RPI * U) == 0, "tile");
  const int col = (tid % V) * 4;
  const int row0 = tid / V;
  const float4 b = __ldg(reinterpret_cast<const float4*>(g.bias + bn0 + col));
  for (int it = 0; it < BM / RPI; it += U) {
    float4 res[U];
    if (EPI == kF32ResRelu) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = bm0 + row0 + (it + u) * RPI;
        res[u] = r < g.M ? __ldg(reinterpret_cast<const float4*>(
                               g.res + (int64_t)r * g.N + bn0 + col))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = row0 + (it + u) * RPI;
      const int r = bm0 + row;
      if (r >= g.M) continue;
      float4 v = *reinterpret_cast<const float4*>(Cs + row * LDC + col);
      v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
      if (EPI == kF32ResRelu) {
        v.x += res[u].x; v.y += res[u].y; v.z += res[u].z; v.w += res[u].w;
      }
      if (EPI != kF32) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      const int64_t at = (int64_t)r * g.N + bn0 + col;
      if (EPI == kBf16Relu) {
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(g.out) + at) =
            make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(g.out) + at) = v;
      }
    }
  }
}

// Lets stage4_gemm_kernel<EPI> take its dynamic shared memory (more than
// 48 KB) on the current device; cudaFuncSetAttribute runs once per device
// and instance.
template <int EPI>
cudaError_t allow_gemm_smem() {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(stage4_gemm_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess) allowed[dev] = true;
  return err;
}

template <int EPI>
cudaError_t gemm(const GemmArgs& g, cudaStream_t stream) {
  cudaError_t err = allow_gemm_smem<EPI>();
  if (err != cudaSuccess) return err;
  const dim3 grid(g.N / kBN, (g.M + kBM - 1) / kBM);
  stage4_gemm_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(g);
  return cudaGetLastError();
}

// ---- the fp32 tail ------------------------------------------------------

constexpr int kCS = 128;     // channels per block, one per thread
constexpr int kMaxPad = 4;   // ktap <= 9
constexpr int kTW = kCS + 2 * kMaxPad;  // staged row width

struct TailF32Args {
  const float* out;      // [B * 49, C] relu(z + id)
  const float* id;       // [B * 49, C]; may be the same memory as yf
  float* yf;             // [B * 49, C] or null
  __nv_bfloat16* yb;     // [B * 49, C]
  const float* wq;       // [ktap]
  const float* wk;       // [ktap]
  const float* wv;       // [9, C], tap (dh + 1) * 3 + (dw + 1)
  const float* lam;      // [C]
  const float* scale;    // [C]
  const float* bias;     // [C]
  int C, ktap, d;        // d = channels per head
};

__global__ void __launch_bounds__(kCS) stage4_tail_kernel(TailF32Args a) {
  __shared__ float tile[kSP][kTW];  // column j is channel c0 - pad + j
  __shared__ float gap[kTW];
  __shared__ float qk[kCS];
  const int t = threadIdx.x;
  const int pad = (a.ktap - 1) / 2;
  const int width = kCS + 2 * pad;
  const int c0 = blockIdx.y * kCS;
  const int64_t row0 = (int64_t)blockIdx.x * kSP;

  // out of this image, channels c0 - pad .. c0 + kCS + pad; zero outside
  // [0, C), as the channel convs pad.
  for (int i = t; i < kSP * width; i += kCS) {
    const int p = i / width;
    const int j = i - p * width;
    const int c = c0 - pad + j;
    tile[p][j] =
        (c >= 0 && c < a.C) ? __ldg(a.out + (row0 + p) * a.C + c) : 0.f;
  }
  __syncthreads();
  for (int j = t; j < width; j += kCS) {
    float s = 0.f;
#pragma unroll 7
    for (int p = 0; p < kSP; ++p) s += tile[p][j];
    gap[j] = s * (1.f / kSP);
  }
  __syncthreads();
  float q = 0.f, k = 0.f;
  for (int j = 0; j < a.ktap; ++j) {  // tap j reads channel c + j - pad
    q = fmaf(__ldg(a.wq + j), gap[t + j], q);
    k = fmaf(__ldg(a.wk + j), gap[t + j], k);
  }
  qk[t] = q * k;
  __syncthreads();
  float s = 0.f;
  const int h0 = t / a.d * a.d;  // first channel of this thread's head
  for (int i = 0; i < a.d; ++i) s += qk[h0 + i];
  const float gate = 1.f / (1.f + expf(-s * rsqrtf((float)a.d)));

  const int c = c0 + t;
  float wv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wv[i] = __ldg(a.wv + i * a.C + c);
  const float lam = __ldg(a.lam + c);
  const float sc = __ldg(a.scale + c);
  const float bi = __ldg(a.bias + c);
  const int col = t + pad;
#pragma unroll
  for (int h = 0; h < kHW; ++h) {
    // the row's 7 identity values are loaded before its first store, so the
    // loads are in flight together (yf may be the same memory as id, and
    // the compiler may not move a load across such a store)
    float idv[kHW];
#pragma unroll
    for (int w = 0; w < kHW; ++w)
      idv[w] = a.id[(row0 + h * kHW + w) * a.C + c];
#pragma unroll
    for (int w = 0; w < kHW; ++w) {
      float acc = 0.f;
#pragma unroll
      for (int dh = -1; dh <= 1; ++dh) {
        if (h + dh < 0 || h + dh >= kHW) continue;
#pragma unroll
        for (int dw = -1; dw <= 1; ++dw) {
          if (w + dw < 0 || w + dw >= kHW) continue;
          acc = fmaf(tile[(h + dh) * kHW + w + dw][col],
                     wv[(dh + 1) * 3 + dw + 1], acc);
        }
      }
      const int64_t at = (row0 + h * kHW + w) * a.C + c;
      const float y = mrla_tail_combine(tile[h * kHW + w][col], acc, gate,
                                        lam, idv[w], sc, bi);
      if (a.yf) a.yf[at] = y;
      a.yb[at] = __float2bfloat16_rn(y);
    }
  }
}

cudaError_t tail(const TailF32Args& a, int B, cudaStream_t stream) {
  const dim3 grid(B, a.C / kCS);
  stage4_tail_kernel<<<grid, kCS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Takes C % 128 == 0, C1 % 128 == 0, CIN % 64 == 0, heads dividing C into
// heads of d channels with 128 % d == 0, and an odd ktap <= 9; anything else
// is cudaErrorInvalidValue.  xs is read in place through its strides (in
// elements; its channels are contiguous).  Scratch: f32 holds 2 * M * C
// floats, yb M * C and x1o 2 * M * C1 bf16 values, M = B * 49.  k1, k2, k3,
// b1, b2, b3 hold blocks 1 and 2 one after the other; wq, wk, wv, lam,
// scale, bias blocks 0, 1 and 2.
extern "C" int mrla_stage4_bf16(
    const void* ob, const void* xs, long long xs_sB, long long xs_sH,
    long long xs_sW, const void* kd, const void* k3_0, const void* k1,
    const void* k2, const void* k3, const void* bd, const void* b3_0,
    const void* b1, const void* b2, const void* b3, const void* wq,
    const void* wk, const void* wv, const void* lam, const void* scale,
    const void* bias, void* f32, void* yb, void* x1o, void* y, int B, int CIN,
    int C1, int C, int heads, int ktap, void* stream) {
  if (B < 0 || CIN <= 0 || C1 <= 0 || C <= 0 || heads <= 0 || C % kBN ||
      C1 % kBN || CIN % kBK || C % heads || kCS % (C / heads) || ktap < 1 ||
      ktap > 2 * kMaxPad + 1 || ktap % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M64 = (int64_t)B * kSP;
  if ((M64 + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int M = (int)M64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  float* outf = static_cast<float*>(f32);
  float* idf = outf + M64 * C;
  bf16* ybuf = static_cast<bf16*>(yb);
  bf16* x1 = static_cast<bf16*>(x1o);
  bf16* o = x1 + M64 * C1;
  const float* fwq = static_cast<const float*>(wq);
  const float* fwk = static_cast<const float*>(wk);
  const float* fwv = static_cast<const float*>(wv);
  const float* flam = static_cast<const float*>(lam);
  const float* fsc = static_cast<const float*>(scale);
  const float* fbi = static_cast<const float*>(bias);

  auto rows = [](const bf16* p, int k) {  // a contiguous [M, k] operand
    GemmArgs g{};
    g.A = p;
    g.sB = (int64_t)kSP * k;
    g.sH = (int64_t)kHW * k;
    g.sW = k;
    g.K = g.Kt = k;
    return g;
  };
  auto tail_of = [&](int blk, float* yf, bf16* yb_out) {
    TailF32Args a{outf, idf, yf, yb_out, fwq + blk * ktap, fwk + blk * ktap,
                  fwv + (int64_t)blk * 9 * C, flam + blk * C, fsc + blk * C,
                  fbi + blk * C, C, ktap, C / heads};
    return tail(a, B, s);
  };
  cudaError_t err;

  // block 0: id0, out = relu(z0 + id0), tail
  GemmArgs g{};
  g.A = static_cast<const bf16*>(xs);
  g.sB = xs_sB; g.sH = xs_sH; g.sW = xs_sW;
  g.W = static_cast<const bf16*>(kd);
  g.bias = static_cast<const float*>(bd);
  g.out = idf;
  g.M = M; g.N = C; g.K = g.Kt = CIN;
  if ((err = gemm<kF32>(g, s)) != cudaSuccess) return (int)err;

  g = rows(static_cast<const bf16*>(ob), C1);
  g.W = static_cast<const bf16*>(k3_0);
  g.bias = static_cast<const float*>(b3_0);
  g.res = idf;
  g.out = outf;
  g.M = M; g.N = C;
  if ((err = gemm<kF32ResRelu>(g, s)) != cudaSuccess) return (int)err;
  if ((err = tail_of(0, idf, ybuf)) != cudaSuccess) return (int)err;

  for (int i = 0; i < 2; ++i) {
    g = rows(ybuf, C);  // x1 = relu(y @ k1 + b1)
    g.W = static_cast<const bf16*>(k1) + (int64_t)i * C1 * C;
    g.bias = static_cast<const float*>(b1) + i * C1;
    g.out = x1;
    g.M = M; g.N = C1;
    if ((err = gemm<kBf16Relu>(g, s)) != cudaSuccess) return (int)err;

    g = rows(x1, C1);  // o = relu(conv3x3(x1, k2) + b2)
    g.K = 9 * C1;
    g.W = static_cast<const bf16*>(k2) + (int64_t)i * C1 * 9 * C1;
    g.bias = static_cast<const float*>(b2) + i * C1;
    g.out = o;
    g.M = M; g.N = C1;
    if ((err = gemm<kBf16Relu>(g, s)) != cudaSuccess) return (int)err;

    g = rows(o, C1);  // out = relu(o @ k3 + b3 + y)
    g.W = static_cast<const bf16*>(k3) + (int64_t)i * C * C1;
    g.bias = static_cast<const float*>(b3) + i * C;
    g.res = idf;
    g.out = outf;
    g.M = M; g.N = C;
    if ((err = gemm<kF32ResRelu>(g, s)) != cudaSuccess) return (int)err;

    const bool last = i == 1;
    err = tail_of(i + 1, last ? nullptr : idf,
                  last ? static_cast<bf16*>(y) : ybuf);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
