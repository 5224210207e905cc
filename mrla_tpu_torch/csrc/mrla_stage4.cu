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
// Design: eight launches of one persistent, warp-specialised product kernel
// behind one C entry point, the block tails in the z products' epilogues.
// The weights (24 MB) fit the 50 MB L2 but not a block, and each gate needs
// a whole image's mean over all C channels, so each product is tiled over
// all SMs and the launch boundary is the barrier between products.
//
//   * stage4_product_kernel: a block of three warpgroups on each SM walks
//     the product's tiles (tile t, t + grid, ..).  In warpgroup 0 one
//     thread produces: it issues TMA copies of W's [BN, 64] chunks and A's
//     into a ring of stages in the 128-byte swizzle that wgmma reads, each
//     stage guarded by a full and an empty mbarrier.  A is a [M, K] matrix
//     in 128-row tiles (y for x1), or a [B, 7, 7, K] map in tiles of two
//     whole images (98 of 128 rows): xs read in place through its strides,
//     ob, o, and x1 for the 3x3, whose chunk of tap (dh, dw) is the box
//     shifted by it, the TMA's zero fill outside the map giving the
//     convolution's zero padding at each image's edge.
//     Warpgroups 1 and 2 consume, taking the block's tiles in turns
//     (ping-pong, an mbarrier passing the turn after each tile's products):
//     each runs a tile's rows as one or two m64 wgmma chains on its own
//     accumulators, and its epilogue overlaps the other warpgroup's
//     products.  setmaxnreg moves registers from the producer to them.
//   * The z products' tiles are two whole images (98 of 128 rows) by 128
//     output channels, computed 136 wide: W's rows c0 - 4 .. c0 + 131 (zero
//     outside [0, C)), so the epilogue has out = relu(z + b + res) for the
//     4 channels on each side that the channel taps (ktap <= 9) read.  Per
//     image the warpgroup stages res (fp32, once) and out in shared memory,
//     reduces the GAP, computes q, k, each head's sum and the gate, then the
//     depthwise 3x3 a thread per channel, and writes y in fp32 (the next
//     block's identity, into the other fp32 buffer: neighbouring tiles still
//     read this block's res at their edges) and in bf16 (the next product's
//     operand, or the stage's output).  out never reaches device memory.
//   * Epilogues of the other products, from the accumulators: bf16 relu
//     (x1, o), fp32 (id0).
//
// No library computes any product: no cuBLAS, no cuDNN, no CUTLASS.  Every
// sum runs in a fixed order: two launches are bitwise equal.
#include <cuda.h>

#include <mutex>

#include "hopper_async.cuh"
#include "mrla_tail.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHW = 7;          // the stage's map is 7 x 7
constexpr int kSP = kHW * kHW;  // pixels per image
constexpr int kBM = 128;        // rows of a consumer's tile: two m64 chains
constexpr int kBK = 64;         // K chunk: one 128-byte row of bf16
constexpr int kRow = 128;       // bytes of a tile row in shared memory
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kCS = 128;        // output channels of a z tile
constexpr int kHalo = 4;        // extra columns on each side: ktap <= 9
constexpr int kTailBN = kCS + 2 * kHalo;  // 136
constexpr int kTileImgs = 2;    // whole images of a 3x3, z or id0 tile
constexpr int kLdE = kTailBN + 4;  // fp32 row stride of the image buffers
constexpr size_t kMaxSmem = 232448;

// A by TMA as [M, K] rows (128-row tiles); as [B, 7, 7, K] images (tiles
// of whole images, 49 of each 64 rows used); or as [7 B, 7, K] image rows
// (tiles of kHRows image rows, 126 of 128 rows used: xs when its image
// stride is 7 row strides, a strided view of a contiguous map)
enum AMode { kRowsA = 0, kImagesA = 1, kImageRowsA = 2 };
constexpr int kHRows = 18;  // image rows of a kImageRowsA tile
enum Epilogue { kBf16Relu = 0, kF32 = 1, kTail = 2 };

struct ProdParams {
  CUtensorMap tmA;      // A: [M, K] box [64, 128], or [B, 7, 7, K] box
                        // [64, 7, 7, images of a tile]; bf16
  CUtensorMap tmW;      // W as [N, K] bf16, box [64, BN]
  int M, N, K;
  int Kt;               // K per tap: K for a 1x1 product, K / 9 for the 3x3
  int m_tiles, n_tiles, tile_rows;  // tile_rows: 128, or 49 an image
  const float* bias;    // [N]
  void* out;            // kBf16Relu: bf16 [M, N]; kF32: fp32 [M, N]
  // kTail
  const float* res;     // [M, N] fp32, the identity
  float* yf;            // [M, N] fp32 or null; never res's memory
  bf16* yb;             // [M, N]
  const float* wq;      // [ktap]
  const float* wk;
  const float* wv;      // [9, N], tap (dh + 1) * 3 + (dw + 1)
  const float* lam;     // [N]
  const float* scale;
  const float* tbias;
  int ktap, d;
};

// ---- Hopper primitives ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A lost
// arrival fails the launch (trap) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d[64 x 128] += A[64 x 16] @ B[128 x 16]^T, both operands from shared
// memory, asynchronously; d is this thread's 64 values of the warpgroup's
// tile (rows 16 * warp + lane / 4 and + 8, columns 8 j + 2 * (lane % 4)).
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// The same, 136 columns wide (the z tiles with their halo): 68 values.
__device__ __forceinline__ void wgmma_n136(float* d, uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67"
      "}, %68, %69, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "l"(a), "l"(b), "r"(1));  // p: accumulate onto d
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 136)
    wgmma_n136(d, a, b);
  else
    wgmma_n128(d, a, b);
}

// ---- shared memory ----------------------------------------------------------

template <int BN, int STAGES, int MI, int EPI>
struct Layout {
  static constexpr int kABytes = MI * 64 * kRow;  // MI m64 chains of rows
  static constexpr int kBBytes = BN * kRow;   // a multiple of 1024
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kBars = 2 * STAGES * 8 + 16;
  // a z tile's per-warpgroup buffers: out and res of one image [49][kLdE]
  // fp32, the GAP and the tile's bias (136 each), q * k (128)
  static constexpr int kEpiFloats = 2 * kSP * kLdE + 2 * kTailBN + kCS;
  static constexpr int kEpi = EPI == kTail ? 2 * kEpiFloats * 4 : 0;
  static constexpr size_t kBytes = 1024 + kRing + kBars + kEpi;
};

// ---- the product kernel ---------------------------------------------------

// MI: m64 wgmma chains of a consumer's tile (its rows: 64 MI, of which MI
// whole images, 49 MI rows, for an image tile).
template <int BN, int STAGES, int MI, int AMODE, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    stage4_product_kernel(const __grid_constant__ ProdParams p) {
  using L = Layout<BN, STAGES, MI, EPI>;
  static_assert(AMODE == kImagesA || MI == 2, "row tiles are 128 rows");
  static_assert(kHRows * kHW <= kBM, "image-row tiles");
  static_assert(EPI != kTail || BN == kTailBN, "z tiles are 136 wide");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kRing);
  uint64_t* empty = full + STAGES;
  // the consumers' turns: phase i completes when tile i's products are done
  uint64_t* order = empty + STAGES;
  float* epi = reinterpret_cast<float*>(order + 2);

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int KT = p.K / kBK;
  const int tiles = p.m_tiles * p.n_tiles;
  // a z tile's W rows start kHalo channels before its 128 output channels
  const int n_step = EPI == kTail ? kCS : BN;
  const int n_lead = EPI == kTail ? kHalo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 1);  // the consuming warpgroup
    }
    mbar_init(order, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t != 0) return;
    const bool conv = p.Kt != p.K;
    const uint32_t a_bytes =
        AMODE == kRowsA        ? L::kABytes
        : AMODE == kImageRowsA ? kHRows * kHW * kRow
                               : MI * kSP * kRow;
    for (int i = 0, tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int mt = tile % p.m_tiles, nt = tile / p.m_tiles;
      const int n0 = nt * n_step - n_lead;
      for (int kt = 0; kt < KT; ++kt) {
        const int it = i * KT + kt;
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* as = ring + s * L::kStage;
        mbar_expect_tx(&full[s], a_bytes + L::kBBytes);
        tma_load_2d(as + L::kABytes, &p.tmW, kt * kBK, n0, &full[s]);
        if (AMODE == kRowsA) {
          tma_load_2d(as, &p.tmA, kt * kBK, mt * kBM, &full[s]);
        } else if (AMODE == kImageRowsA) {
          tma_load_3d(as, &p.tmA, kt * kBK, 0, mt * kHRows, &full[s]);
        } else {
          // whole images; for the 3x3, chunk kt belongs to tap k0 / Kt
          // (a chunk never straddles two taps) and reads the pixels
          // shifted by it, zero outside their own image
          const int k0 = kt * kBK;
          const int tap = k0 / p.Kt;
          const int dh = conv ? tap / 3 - 1 : 0;
          const int dw = conv ? tap % 3 - 1 : 0;
          tma_load_4d(as, &p.tmA, k0 - tap * p.Kt, dw, dh, mt * MI,
                      &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2 take the block's tiles in turns ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int warp = t >> 5, lane = t & 31;
  float* eo = epi + cw * L::kEpiFloats;  // out of one image [49][kLdE]
  float* er = eo + kSP * kLdE;           // res of one image [49][kLdE]
  float* gap = er + kSP * kLdE;          // [kTailBN]
  float* bias_s = gap + kTailBN;         // [kTailBN]
  float* qk = bias_s + kTailBN;          // [kCS]
  constexpr int NV = BN / 2;             // accumulator values per m64 chain

  for (int i = 0, tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    if ((i & 1) != cw) continue;
    const int mt = tile % p.m_tiles, nt = tile / p.m_tiles;
    const int m0 = mt * p.tile_rows;
    const int n0 = nt * n_step - n_lead;

    // a z tile's identity rows of image im, channels n0 .. n0 + 135 (zero
    // outside [0, N)), in fp32 by 16-byte copies: the first image's are in
    // flight while the products run
    auto load_res = [&](int im) {
      const int prow = m0 + im * kSP;
      for (int q = t; q < kSP * (kTailBN / 4); q += 128) {
        const int px = q / (kTailBN / 4), v = q - px * (kTailBN / 4);
        const int cc = n0 + 4 * v;
        const bool ok = cc >= 0 && cc < p.N && prow + px < p.M;
        cp_async16(er + px * kLdE + 4 * v,
                   ok ? p.res + (long long)(prow + px) * p.N + cc : p.res,
                   ok);
      }
      cp_async_commit();
    };
    if constexpr (EPI == kTail) load_res(0);

    float acc[MI][NV];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[mi][j] = 0.f;
    // The warpgroups' products run in turns, tile by tile: a warpgroup
    // starts tile i's once tile i - 1's are done.  So it waits on a stage
    // only after every earlier fill of it has been waited on, and each
    // parity wait is at most one phase ahead of the barrier.
    if (i > 0) mbar_wait(order, (i - 1) & 1);
    for (int kt = 0; kt < KT; ++kt) {
      const int it = i * KT + kt;
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      unsigned char* as = ring + s * L::kStage;
      const uint64_t da = wgmma_desc(as);
      const uint64_t db = wgmma_desc(as + L::kABytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        // a k16 step moves 32 bytes; each chain is 64 rows further
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          wgmma_bn<BN>(acc[mi], da + mi * ((64 * kRow) >> 4) + 2 * ks,
                       db + 2 * ks);
      }
      wgmma_commit();
      // chunk kt - 1's products are done: its stage goes back
      wgmma_wait<1>();
      if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    if (t == 0) {
      mbar_arrive(&empty[(i * KT + KT - 1) % STAGES]);
      mbar_arrive(order);  // the other warpgroup's turn
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        asm volatile("" : "+f"(acc[mi][j])::"memory");

    if constexpr (EPI != kTail) {
      // straight from the fragments: 4 lanes hold 8 (16) contiguous bytes of
      // a row
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mi * 64 + warp * 16 + (lane >> 2) + 8 * half;
          const int r = m0 + row;
          if (row >= p.tile_rows || r >= p.M) continue;
#pragma unroll
          for (int jj = 0; jj < NV / 4; ++jj) {
            const int c = n0 + 8 * jj + 2 * (lane & 3);
            const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + c));
            float v0 = acc[mi][4 * jj + 2 * half] + b.x;
            float v1 = acc[mi][4 * jj + 2 * half + 1] + b.y;
            const long long at = (long long)r * p.N + c;
            if (EPI == kBf16Relu) {
              *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + at) =
                  pack_bf16x2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
                  make_float2(v0, v1);
            }
          }
        }
    } else {
      // ---- the block tail, an image at a time ----
      const int bar = 1 + cw;
      const int pad = (p.ktap - 1) / 2;
      for (int j = t; j < kTailBN; j += 128) {
        const int c = n0 + j;
        bias_s[j] = (c >= 0 && c < p.N) ? __ldg(p.bias + c) : 0.f;
      }
      // this thread's channel in the tail's last steps
      const int cj = kHalo + t;  // column of the tile
      const int c = n0 + cj;
      float wv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wv[k] = __ldg(p.wv + k * p.N + c);
      const float lam = __ldg(p.lam + c);
      const float sc = __ldg(p.scale + c);
      const float bi = __ldg(p.tbias + c);

      for (int k = 0; k < MI; ++k) {
        const int prow = m0 + k * kSP;  // the image's first row
        if (prow >= p.M) break;
        // 1. the image's identity rows in shared memory
        if (k > 0) load_res(k);
        cp_async_wait<0>();
        named_sync(bar);
        // 2. out = relu(z + b + res) of the fragment rows in this image
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int px =
                mi * 64 + warp * 16 + (lane >> 2) + 8 * half - k * kSP;
            if (px < 0 || px >= kSP) continue;
#pragma unroll
            for (int jj = 0; jj < NV / 4; ++jj) {
              const int j = 8 * jj + 2 * (lane & 3);
              const float2 rr =
                  *reinterpret_cast<const float2*>(er + px * kLdE + j);
              const float v0 =
                  fmaxf(acc[mi][4 * jj + 2 * half] + bias_s[j] + rr.x, 0.f);
              const float v1 = fmaxf(
                  acc[mi][4 * jj + 2 * half + 1] + bias_s[j + 1] + rr.y, 0.f);
              *reinterpret_cast<float2*>(eo + px * kLdE + j) =
                  make_float2(v0, v1);
            }
          }
        named_sync(bar);
        // 3. GAP over the image's 49 pixels (out is 0 outside [0, N))
        for (int j = t; j < kTailBN; j += 128) {
          float s = 0.f;
#pragma unroll 7
          for (int px = 0; px < kSP; ++px) s += eo[px * kLdE + j];
          gap[j] = s * (1.f / kSP);
        }
        named_sync(bar);
        // 4. q * k of this thread's channel: tap j reads channel c + j - pad
        {
          float q = 0.f, k = 0.f;
          for (int j = 0; j < p.ktap; ++j) {
            const float g = gap[cj + j - pad];
            q = fmaf(__ldg(p.wq + j), g, q);
            k = fmaf(__ldg(p.wk + j), g, k);
          }
          qk[t] = q * k;
        }
        named_sync(bar);
        // 5. the gate: heads of d channels, d dividing 128
        float gate;
        {
          float s = 0.f;
          const int h0 = t / p.d * p.d;
          for (int j = 0; j < p.d; ++j) s += qk[h0 + j];
          gate = 1.f / (1.f + expf(-s * rsqrtf((float)p.d)));
        }
        // 6. y of channel c at the image's 49 pixels: a row at a time, the
        // 3 x 3 window of out in registers, one new column a pixel (taps
        // outside the image read 0, which adds exactly 0)
        {
          const float* col = eo + cj;
          auto at = [&](int hh, int ww) {
            return (hh >= 0 && hh < kHW && ww >= 0 && ww < kHW)
                       ? col[(hh * kHW + ww) * kLdE]
                       : 0.f;
          };
#pragma unroll
          for (int h = 0; h < kHW; ++h) {
            float win[3][3];  // [w - 1 .. w + 1][h - 1 .. h + 1]
#pragma unroll
            for (int dh = 0; dh < 3; ++dh) {
              win[0][dh] = 0.f;
              win[1][dh] = at(h + dh - 1, 0);
            }
#pragma unroll
            for (int w = 0; w < kHW; ++w) {
#pragma unroll
              for (int dh = 0; dh < 3; ++dh)
                win[2][dh] = at(h + dh - 1, w + 1);
              float a = 0.f;
#pragma unroll
              for (int dh = 0; dh < 3; ++dh)
#pragma unroll
                for (int dw = 0; dw < 3; ++dw)
                  a = fmaf(win[dw][dh], wv[dh * 3 + dw], a);
              const int px = h * kHW + w;
              const float y = mrla_tail_combine(win[1][1], a, gate, lam,
                                                er[px * kLdE + cj], sc, bi);
              const long long at_g = (long long)(prow + px) * p.N + c;
              if (p.yf) p.yf[at_g] = y;
              p.yb[at_g] = __float2bfloat16_rn(y);
#pragma unroll
              for (int dh = 0; dh < 3; ++dh) {
                win[0][dh] = win[1][dh];
                win[1][dh] = win[2][dh];
              }
            }
          }
        }
        named_sync(bar);  // the buffers are free for the next image
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  });
  return fn;
}

// A [rows, k] bf16 matrix (row stride `ld` elements) in boxes of [64, box_rows]
// with the 128-byte swizzle; rows and columns past the edges read as zero.
bool make_map(CUtensorMap* m, const void* base, int k, int rows, long long ld,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, 7, 7, k] bf16 map of images (strides in elements; channels
// contiguous) in boxes of [64, 7, 7, imgs] with the 128-byte swizzle: a box
// is imgs whole images, 49 imgs rows of 128 bytes; pixels and images past
// the edges (the 3x3's shifted taps, a last odd image) read as zero.
bool make_image_map(CUtensorMap* m, const void* base, int k, int B,
                    long long sW, long long sH, long long sB, int imgs) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)k, kHW, kHW, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sW * 2, (cuuint64_t)sH * 2,
                                 (cuuint64_t)sB * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, kHW, kHW, (cuuint32_t)imgs};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [7 B, 7, k] bf16 map of image rows (xs: its pixel stride sW and row
// stride sH in elements, the image stride 7 sH) in boxes of [64, 7, kHRows]
// with the 128-byte swizzle; rows past the last image read as zero.
bool make_image_rows_map(CUtensorMap* m, const void* base, int k, int B,
                         long long sW, long long sH) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k, kHW, (cuuint64_t)B * kHW};
  const cuuint64_t strides[2] = {(cuuint64_t)sW * 2, (cuuint64_t)sH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, kHW, kHRows};
  const cuuint32_t es[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  static std::once_flag once;
  std::call_once(once, [] {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  });
  return n;
}

// The eight products of a call, in order, and their instances' ring depths.
enum Step { kId0 = 0, kZ0, kX1a, kOa, kZ1, kX1b, kOb, kZ2, kSteps };
constexpr int kStagesPlain = 6;  // 6 x 32 KB
constexpr int kStagesTail = 3;   // 3 x 33 KB + 2 x 55 KB of tail buffers

template <int BN, int STAGES, int MI, int AMODE, int EPI>
cudaError_t launch_product(const ProdParams& p, cudaStream_t stream) {
  using L = Layout<BN, STAGES, MI, EPI>;
  static_assert(L::kBytes <= kMaxSmem, "shared memory");
  auto kernel = stage4_product_kernel<BN, STAGES, MI, AMODE, EPI>;
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
      if (err != cudaSuccess) return err;
      allowed[dev] = true;
    }
  }
  const int tiles = p.m_tiles * p.n_tiles;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  if (grid <= 0) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

struct Stage4Args {
  const bf16 *ob, *xs;
  long long xs_sB, xs_sH, xs_sW;
  const bf16 *kd, *k3_0, *k1, *k2, *k3;
  const float *bd, *b3_0, *b1, *b2, *b3, *wq, *wk, *wv, *lam, *scale, *bias;
  float* f32;   // two [M, C] fp32 buffers
  bf16* yb;     // [M, C]
  bf16* x1o;    // x1 then o, [M, C1] each
  bf16* y;      // [M, C]
  int B, CIN, C1, C, heads, ktap;
};

// xs's images are 7 of its rows apart: id0 takes tiles of image rows.
bool image_rows(const Stage4Args& a) { return a.xs_sB == kHW * a.xs_sH; }

// The parameters of step `step` (maps encoded), or false if a map fails.
bool step_params(const Stage4Args& a, int step, ProdParams& p) {
  p = ProdParams{};
  const int M = a.B * kSP;
  const long long MC = (long long)M * a.C;
  float* F0 = a.f32;
  float* F1 = a.f32 + MC;
  bf16* x1 = a.x1o;
  bf16* o = a.x1o + (long long)M * a.C1;
  p.M = M;
  auto rows = [&](int N, int K) {  // 128-row tiles of a plain [M, K] A
    p.N = N;
    p.K = p.Kt = K;
    p.tile_rows = kBM;
    p.m_tiles = (M + kBM - 1) / kBM;
    p.n_tiles = N / 128;
  };
  auto images = [&](int N, int K, int n_tile) {  // whole-image tiles
    p.N = N;
    p.K = p.Kt = K;
    p.tile_rows = kTileImgs * kSP;
    p.m_tiles = (a.B + kTileImgs - 1) / kTileImgs;
    p.n_tiles = N / n_tile;
  };
  auto tail = [&](int blk, const float* res, float* yf, bf16* yb) {
    images(a.C, a.C1, kCS);
    p.res = res;
    p.yf = yf;
    p.yb = yb;
    p.wq = a.wq + blk * a.ktap;
    p.wk = a.wk + blk * a.ktap;
    p.wv = a.wv + (long long)blk * 9 * a.C;
    p.lam = a.lam + blk * a.C;
    p.scale = a.scale + blk * a.C;
    p.tbias = a.bias + blk * a.C;
    p.ktap = a.ktap;
    p.d = a.C / a.heads;
  };
  // a contiguous [B, 7, 7, k] map
  auto dense = [&](const bf16* base, int k) {
    return make_image_map(&p.tmA, base, k, a.B, k, (long long)kHW * k,
                          (long long)kSP * k, kTileImgs);
  };
  const int blk = step < kX1b ? 0 : 1;  // of blocks 1 and 2's weights
  switch (step) {
    case kId0:  // id0 = xs @ kd + bd, xs read in place through its strides
      p.bias = a.bd;
      p.out = F0;
      if (image_rows(a)) {
        p.N = a.C;
        p.K = p.Kt = a.CIN;
        p.tile_rows = kHRows * kHW;
        p.m_tiles = (a.B * kHW + kHRows - 1) / kHRows;
        p.n_tiles = a.C / 128;
        return make_image_rows_map(&p.tmA, a.xs, a.CIN, a.B, a.xs_sW,
                                   a.xs_sH) &&
               make_map(&p.tmW, a.kd, a.CIN, a.C, a.CIN, 128);
      }
      images(a.C, a.CIN, 128);
      return make_image_map(&p.tmA, a.xs, a.CIN, a.B, a.xs_sW, a.xs_sH,
                            a.xs_sB, kTileImgs) &&
             make_map(&p.tmW, a.kd, a.CIN, a.C, a.CIN, 128);
    case kZ0:  // y = tail(relu(ob @ k3_0 + b3_0 + id0), id0)
      tail(0, F0, F1, a.yb);
      p.bias = a.b3_0;
      return dense(a.ob, a.C1) &&
             make_map(&p.tmW, a.k3_0, a.C1, a.C, a.C1, kTailBN);
    case kX1a:
    case kX1b:  // x1 = relu(y @ k1 + b1)
      rows(a.C1, a.C);
      p.bias = a.b1 + blk * a.C1;
      p.out = x1;
      return make_map(&p.tmA, a.yb, a.C, M, a.C, kBM) &&
             make_map(&p.tmW, a.k1 + (long long)blk * a.C1 * a.C, a.C, a.C1,
                      a.C, 128);
    case kOa:
    case kOb:  // o = relu(conv3x3(x1) + b2): x1's images shifted by tap
      images(a.C1, 9 * a.C1, 128);
      p.Kt = a.C1;
      p.bias = a.b2 + blk * a.C1;
      p.out = o;
      return dense(x1, a.C1) &&
             make_map(&p.tmW, a.k2 + (long long)blk * a.C1 * 9 * a.C1,
                      9 * a.C1, a.C1, 9 * a.C1, 128);
    default: {  // z: y = tail(relu(o @ k3 + b3 + y), y)
      const bool last = step == kZ2;
      tail(step == kZ1 ? 1 : 2, last ? F0 : F1, last ? nullptr : F0,
           last ? a.y : a.yb);
      p.bias = a.b3 + (last ? 1 : 0) * a.C;
      return dense(o, a.C1) &&
             make_map(&p.tmW, a.k3 + (long long)(last ? 1 : 0) * a.C * a.C1,
                      a.C1, a.C, a.C1, kTailBN);
    }
  }
}

cudaError_t run_step(const Stage4Args& a, int step, cudaStream_t s) {
  ProdParams p;
  if (!step_params(a, step, p)) return cudaErrorInvalidValue;
  switch (step) {
    case kId0:
      return image_rows(a)
                 ? launch_product<128, kStagesPlain, 2, kImageRowsA, kF32>(p,
                                                                           s)
                 : launch_product<128, kStagesPlain, kTileImgs, kImagesA,
                                  kF32>(p, s);
    case kX1a:
    case kX1b:
      return launch_product<128, kStagesPlain, 2, kRowsA, kBf16Relu>(p, s);
    case kOa:
    case kOb:
      return launch_product<128, kStagesPlain, kTileImgs, kImagesA,
                            kBf16Relu>(p, s);
    default:  // z with the block tail
      return launch_product<kTailBN, kStagesTail, kTileImgs, kImagesA, kTail>(
          p, s);
  }
}

bool supported(int B, int CIN, int C1, int C, int heads, int ktap) {
  return B >= 0 && CIN > 0 && C1 > 0 && C > 0 && heads > 0 && C % kCS == 0 &&
         C1 % 128 == 0 && CIN % kBK == 0 && C % heads == 0 &&
         kCS % (C / heads) == 0 && ktap >= 1 && ktap <= 2 * kHalo + 1 &&
         ktap % 2 == 1 && (long long)B * kSP < (1LL << 30);
}

Stage4Args args_of(const void* ob, const void* xs, long long xs_sB,
                   long long xs_sH, long long xs_sW, const void* kd,
                   const void* k3_0, const void* k1, const void* k2,
                   const void* k3, const void* bd, const void* b3_0,
                   const void* b1, const void* b2, const void* b3,
                   const void* wq, const void* wk, const void* wv,
                   const void* lam, const void* scale, const void* bias,
                   void* f32, void* yb, void* x1o, void* y, int B, int CIN,
                   int C1, int C, int heads, int ktap) {
  Stage4Args a;
  a.ob = static_cast<const bf16*>(ob);
  a.xs = static_cast<const bf16*>(xs);
  a.xs_sB = xs_sB; a.xs_sH = xs_sH; a.xs_sW = xs_sW;
  a.kd = static_cast<const bf16*>(kd);
  a.k3_0 = static_cast<const bf16*>(k3_0);
  a.k1 = static_cast<const bf16*>(k1);
  a.k2 = static_cast<const bf16*>(k2);
  a.k3 = static_cast<const bf16*>(k3);
  a.bd = static_cast<const float*>(bd);
  a.b3_0 = static_cast<const float*>(b3_0);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.wq = static_cast<const float*>(wq);
  a.wk = static_cast<const float*>(wk);
  a.wv = static_cast<const float*>(wv);
  a.lam = static_cast<const float*>(lam);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.f32 = static_cast<float*>(f32);
  a.yb = static_cast<bf16*>(yb);
  a.x1o = static_cast<bf16*>(x1o);
  a.y = static_cast<bf16*>(y);
  a.B = B; a.CIN = CIN; a.C1 = C1; a.C = C; a.heads = heads; a.ktap = ktap;
  return a;
}

}  // namespace

// Takes C % 128 == 0, C1 % 128 == 0, CIN % 64 == 0, heads dividing C into
// heads of d channels with 128 % d == 0, and an odd ktap <= 9; anything else
// is cudaErrorInvalidValue.  xs is read in place through its strides (in
// elements; its channels are contiguous, 16-byte aligned).  Scratch: f32
// holds 2 * M * C floats, yb M * C and x1o 2 * M * C1 bf16 values,
// M = B * 49.  k1, k2, k3, b1, b2, b3 hold blocks 1 and 2 one after the
// other; wq, wk, wv, lam, scale, bias blocks 0, 1 and 2.
extern "C" int mrla_stage4_bf16(
    const void* ob, const void* xs, long long xs_sB, long long xs_sH,
    long long xs_sW, const void* kd, const void* k3_0, const void* k1,
    const void* k2, const void* k3, const void* bd, const void* b3_0,
    const void* b1, const void* b2, const void* b3, const void* wq,
    const void* wk, const void* wv, const void* lam, const void* scale,
    const void* bias, void* f32, void* yb, void* x1o, void* y, int B, int CIN,
    int C1, int C, int heads, int ktap, void* stream) {
  if (!supported(B, CIN, C1, C, heads, ktap))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Stage4Args a = args_of(ob, xs, xs_sB, xs_sH, xs_sW, kd, k3_0, k1, k2,
                               k3, bd, b3_0, b1, b2, b3, wq, wk, wv, lam,
                               scale, bias, f32, yb, x1o, y, B, CIN, C1, C,
                               heads, ktap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int step = 0; step < kSteps; ++step) {
    const cudaError_t err = run_step(a, step, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The eight launches' plans at batch B (xs a strided view of a dense map,
// as the engine passes it): for step i, out[6 i ..] = tiles, blocks (one an
// SM, persistent), a tile's rows used (98 of 128 for two whole images, 126
// for id0's 18 image rows) and columns computed, ring stages, shared
// memory bytes a block.
extern "C" int mrla_stage4_describe(int B, int CIN, int C1, int C, int* out) {
  const int M = B * kSP;
  const int sms = sm_count();
  for (int step = 0; step < kSteps; ++step) {
    int* o = out + 6 * step;
    const bool z = step == kZ0 || step == kZ1 || step == kZ2;
    const bool x1 = step == kX1a || step == kX1b;
    const int N = (z || step == kId0) ? C : C1;
    const bool rows = step == kId0;  // xs a strided view of a dense map
    const int tiles = x1     ? ((M + kBM - 1) / kBM) * (N / 128)
                      : rows ? ((B * kHW + kHRows - 1) / kHRows) * (N / 128)
                             : ((B + kTileImgs - 1) / kTileImgs) *
                                   (N / (z ? kCS : 128));
    o[0] = tiles;
    o[1] = tiles < sms ? tiles : sms;
    o[2] = x1 ? kBM : rows ? kHRows * kHW : kTileImgs * kSP;
    o[3] = z ? kTailBN : 128;
    o[4] = z ? kStagesTail : kStagesPlain;
    o[5] = (int)(z ? Layout<kTailBN, kStagesTail, kTileImgs, kTail>::kBytes
                   : Layout<128, kStagesPlain, 2, kF32>::kBytes);
  }
  (void)CIN;
  return sms > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidDevice;
}
