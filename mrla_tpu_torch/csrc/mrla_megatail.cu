// MRLA-light block tail fused with the next block's 1x1 conv, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel mrla_tpu/kernels/mrla_megatail.py
// (mrla_block_tail_fused_next -> _kernel).  In one pass over the map:
//
//     y  = out + (dwconv3x3(out) * gate + lam * id) * bn_scale + bn_bias
//     x1 = relu(bf16(y) @ W1 + b1)        (the next block's conv1, BN folded)
//
// and returns both, so y never makes a second trip through device memory
// to feed the next conv.
//
// Bound on an H100: memory.  Stage 1 of resnet50 at 224 px, batch 128
// (out, id, y [128, 56, 56, 256] bf16, x1 with C1 = 64) moves 668 MB, 0.199
// ms at 3.35 TB/s, while its product is 13.2 GFLOP, 0.013 ms at the bf16
// tensor-core peak: the product has to stay cheap enough to hide under the
// memory traffic, and must not send y back to memory.
//
// Design: a CTA owns 64 pixels x all C channels.
//   1. Its 256 threads compute y as the epilogue kernel does (8 channels a
//      thread, 16-byte accesses along C, 3x3 taps from global memory), write
//      y out and keep the tile in shared memory as bf16: the product reads
//      exactly the rounded y that was written.
//   2. Eight warps (4 along the pixels x 2 along C1) compute the 64 x C1
//      product with mma.sync m16n8k16 (bf16 in, fp32 accumulate).  W1, given
//      as the conv weight [C1, C], is streamed through shared memory in
//      64-deep K chunks: at C = 512, C1 = 256 it is 256 KB and does not fit
//      a block's 227 KB.  Rows are padded by 8 bf16 so the fragment loads
//      are free of bank conflicts.
//   3. bias + ReLU in registers, x1 stored as bf16 pairs.
// Shared memory is 64 x (C + 8) + C1 x 72 bf16: 101 KB at C = 512, C1 = 256,
// so two CTAs fit an SM.  The product uses no library: no cuBLAS, no
// CUTLASS device GEMM.
#include <mutex>

#include "mrla_tail.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kBM = 64;        // pixels per CTA
constexpr int kKC = 64;        // K chunk of W1 staged in shared memory
constexpr int kPad = 8;        // bf16 row padding (conflict-free fragments)
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// Shared memory of one block: the y tile and one K chunk of W1.  The
// wrapper's megatail_covers (kernels/mrla_megatail.py) states the same.
size_t smem_bytes(int C, int C1) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kBM * (C + kPad) + (size_t)C1 * (kKC + kPad));
}

__device__ __forceinline__ void mma_16816(float d[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// NT: n-tiles of 8 columns per warp; C1 = 2 warps x 8 x NT.
template <int NT>
__global__ void __launch_bounds__(kThreads)
    mrla_megatail_kernel(TailArgs a, const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         __nv_bfloat16* __restrict__ y,
                         __nv_bfloat16* __restrict__ x1, int64_t P) {
  constexpr int C1 = 16 * NT;
  constexpr int ldw = kKC + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int ldy = C + kPad;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBM][ldy]
  __nv_bfloat16* ws = ys + kBM * ldy;                           // [C1][ldw]
  const int64_t p0 = (int64_t)blockIdx.x * kBM;

  // 1. y for the tile; rows past the end of the map are zero in shared
  //    memory and never stored.
  const int vecs = C / 8;
  for (int i = threadIdx.x; i < kBM * vecs; i += kThreads) {
    const int m = i / vecs;
    const int c0 = (i % vecs) * 8;
    const int64_t p = p0 + m;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) {
      r = mrla_tail_y8(a, p, c0);
      *reinterpret_cast<uint4*>(y + p * C + c0) = r;
    }
    *reinterpret_cast<uint4*>(ys + m * ldy + c0) = r;
  }

  // 2. x1 = ys @ W1^T over K chunks of W1.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;  // thread in group
  const int row0 = (warp & 3) * 16;
  const int col0 = (warp >> 2) * (8 * NT);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    __syncthreads();  // ys complete / previous chunk consumed
    for (int i = threadIdx.x; i < C1 * (kKC / 8); i += kThreads) {
      const int n = i / (kKC / 8);
      const int kk = (i % (kKC / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + n * ldw + kk) = __ldg(
          reinterpret_cast<const uint4*>(w1 + (int64_t)n * C + k0 + kk));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      const __nv_bfloat16* ap = ys + (row0 + g) * ldy + k0 + ks + 2 * tq;
      const uint32_t a0 = lds32(ap);
      const uint32_t a1 = lds32(ap + 8 * ldy);
      const uint32_t a2 = lds32(ap + 8);
      const uint32_t a3 = lds32(ap + 8 * ldy + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* bp = ws + (col0 + 8 * j + g) * ldw + ks + 2 * tq;
        mma_16816(acc[j], a0, a1, a2, a3, lds32(bp), lds32(bp + 8));
      }
    }
  }

  // 3. bias + ReLU, bf16 pairs out.
  const int64_t pa = p0 + row0 + g;
  const int64_t pb = pa + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = col0 + 8 * j + 2 * tq;
    const float bb0 = __ldg(b1 + n);
    const float bb1 = __ldg(b1 + n + 1);
    if (pa < P)
      *reinterpret_cast<uint32_t*>(x1 + pa * C1 + n) = pack_bf16x2(
          fmaxf(acc[j][0] + bb0, 0.f), fmaxf(acc[j][1] + bb1, 0.f));
    if (pb < P)
      *reinterpret_cast<uint32_t*>(x1 + pb * C1 + n) = pack_bf16x2(
          fmaxf(acc[j][2] + bb0, 0.f), fmaxf(acc[j][3] + bb1, 0.f));
  }
}

// Lets mrla_megatail_kernel<NT> take `smem` bytes of dynamic shared memory
// on the current device.  cudaFuncSetAttribute runs only when a launch needs
// more than was allowed so far, not on every launch; it fails when `smem`
// exceeds what a block may have.
template <int NT>
cudaError_t allow_smem(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mrla_megatail_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

template <int NT>
cudaError_t launch(const TailArgs& a, const void* w1, const void* b1,
                   void* y, void* x1, int64_t P, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.C, 16 * NT);
  cudaError_t err = allow_smem<NT>(smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (P + kBM - 1) / kBM;
  if (blocks > 0) {
    mrla_megatail_kernel<NT><<<(unsigned)blocks, kThreads, smem, stream>>>(
        a, static_cast<const __nv_bfloat16*>(w1),
        static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(x1), P);
  }
  return cudaGetLastError();
}

}  // namespace

// C % 64 == 0, C1 in {64, 128, 256} and smem_bytes(C, C1) <= kMaxSmem (so
// C up to 1472 at C1 = 256), else cudaErrorInvalidValue; the engine routes
// by the same three conditions (megatail_covers).
extern "C" int mrla_megatail_bf16(const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, const void* w1,
                                  const void* b1, void* y, void* x1, int B,
                                  int H, int W, int C, int C1, void* stream) {
  if (C <= 0 || C % kKC || smem_bytes(C, C1) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  TailArgs a{static_cast<const __nv_bfloat16*>(out),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate),
             static_cast<const float*>(wv),
             static_cast<const float*>(lam),
             static_cast<const float*>(scale),
             static_cast<const float*>(bias),
             H, W, C};
  const int64_t P = (int64_t)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C1) {
    case 64: err = launch<4>(a, w1, b1, y, x1, P, s); break;
    case 128: err = launch<8>(a, w1, b1, y, x1, P, s); break;
    case 256: err = launch<16>(a, w1, b1, y, x1, P, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
