// The MRLA-light block tail fused with the next block's 1x1 conv, shared by
// the mega-tail (mrla_megatail.cu) and the row tail (mrla_rowtail.cu), which
// differ only in how y is summed (YOp::y8, 8 channels of one pixel):
//
//     y  = YOp::y8(...)                    (bf16, written out)
//     x1 = relu(bf16(y) @ W1 + b1)         (the next block's conv1, BN folded)
//
// so y never makes a second trip through device memory to feed the next
// conv.  A block owns BM = 16 WM pixels x all C channels:
//   1. its 256 threads compute y (8 channels a thread, 16-byte accesses
//      along C, 3x3 taps from global memory), write y out and keep the tile
//      in shared memory as bf16: the product reads exactly the rounded y
//      that was written;
//   2. eight warps (WM along the pixels x 8 / WM along the columns) compute
//      x1 in chunks of CN = (8 / WM) x 8 x NT columns with mma.sync
//      m16n8k16 (bf16 in, fp32 accumulate), so a chunk's accumulators stay
//      in registers (NT x 4 a thread).  W1, given as the conv weight
//      [C1, C], is streamed through shared memory in 64-deep K chunks; rows
//      are padded by 8 bf16 so the fragment loads are free of bank
//      conflicts;
//   3. bias + ReLU in registers, x1 stored as bf16 pairs.
// Shared memory is BM x (C + 8) + CN x 72 bf16 (tail_x1_smem_bytes).  The
// product uses no library: no cuBLAS, no CUTLASS device GEMM.
#pragma once

#include <mutex>

#include "mrla_tail.cuh"

namespace {

// mma.sync m16n8k16, bf16 in, fp32 accumulate, and the 32-bit shared-memory
// loads of its fragments.
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


constexpr int kX1Threads = 256;  // 8 warps
constexpr int kX1KC = 64;        // K chunk of W1 staged in shared memory
constexpr int kX1Pad = 8;        // bf16 row padding
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// Shared memory of one block: the y tile [BM, C + 8] and a K chunk of CN
// rows of W1 [CN, 64 + 8], bf16.
size_t tail_x1_smem_bytes(int C, int BM, int CN) {
  return sizeof(__nv_bfloat16) *
         ((size_t)BM * (C + kX1Pad) + (size_t)CN * (kX1KC + kX1Pad));
}

// Blocks a 64-pixel tile asks to fit on an SM: 4 up to NT = 8 (64
// registers a thread), 2 at NT = 16 (128), so that where shared memory
// allows (C <= 512) the register count does not cut occupancy further.  A
// 32-pixel tile (the row tail above C = 512) is held to one or two blocks an
// SM by its shared memory and takes the registers it wants.
constexpr int tail_x1_min_blocks(int WM, int NT) {
  return WM == 4 ? (NT <= 8 ? 4 : 2) : 1;
}

// kC1 > 0 fixes C1 at compile time (the mega-tail's one chunk).
template <class YOp, int WM, int NT, int kC1>
__global__ void __launch_bounds__(kX1Threads, tail_x1_min_blocks(WM, NT))
    tail_x1_kernel(TailArgs a, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1,
                   __nv_bfloat16* __restrict__ y,
                   __nv_bfloat16* __restrict__ x1, int64_t P, int C1_arg) {
  const int C1 = kC1 > 0 ? kC1 : C1_arg;
  constexpr int BM = 16 * WM;
  constexpr int CN = (8 / WM) * 8 * NT;
  constexpr int ldw = kX1KC + kX1Pad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int ldy = C + kX1Pad;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][ldy]
  __nv_bfloat16* ws = ys + BM * ldy;                            // [CN][ldw]
  const int64_t p0 = (int64_t)blockIdx.x * BM;

  // 1. y for the tile; rows past the end of the map are zero in shared
  //    memory and never stored.
  const int vecs = C / 8;
  for (int i = threadIdx.x; i < BM * vecs; i += kX1Threads) {
    const int m = i / vecs;
    const int c0 = (i % vecs) * 8;
    const int64_t p = p0 + m;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) {
      r = YOp::y8(a, p, c0);
      *reinterpret_cast<uint4*>(y + p * C + c0) = r;
    }
    *reinterpret_cast<uint4*>(ys + m * ldy + c0) = r;
  }

  // 2. x1 = ys @ W1^T, one chunk of CN columns at a time.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;  // thread in group
  const int row0 = (warp % WM) * 16;
  const int col0 = (warp / WM) * (8 * NT);
  for (int n0 = 0; n0 < C1; n0 += CN) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kX1KC) {
      __syncthreads();  // ys complete / previous chunk consumed
      for (int i = threadIdx.x; i < CN * (kX1KC / 8); i += kX1Threads) {
        const int n = i / (kX1KC / 8);
        const int kk = (i % (kX1KC / 8)) * 8;
        *reinterpret_cast<uint4*>(ws + n * ldw + kk) =
            __ldg(reinterpret_cast<const uint4*>(
                w1 + (int64_t)(n0 + n) * C + k0 + kk));
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kX1KC; ks += 16) {
        const __nv_bfloat16* ap = ys + (row0 + g) * ldy + k0 + ks + 2 * tq;
        const uint32_t a0 = lds32(ap);
        const uint32_t a1 = lds32(ap + 8 * ldy);
        const uint32_t a2 = lds32(ap + 8);
        const uint32_t a3 = lds32(ap + 8 * ldy + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* bp =
              ws + (col0 + 8 * j + g) * ldw + ks + 2 * tq;
          mma_16816(acc[j], a0, a1, a2, a3, lds32(bp), lds32(bp + 8));
        }
      }
    }

    // 3. bias + ReLU, bf16 pairs out.
    const int64_t pa = p0 + row0 + g;
    const int64_t pb = pa + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + col0 + 8 * j + 2 * tq;
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
}

// Lets tail_x1_kernel<YOp, WM, NT, kC1> take `smem` bytes of dynamic shared
// memory on the current device.  cudaFuncSetAttribute runs only when a
// launch needs more than was allowed so far, not on every launch; it fails
// when `smem` exceeds what a block may have.
template <class YOp, int WM, int NT, int kC1>
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
  err = cudaFuncSetAttribute(tail_x1_kernel<YOp, WM, NT, kC1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

// y [B, H, W, C] and x1 [B, H, W, C1] for P = B H W pixels; C1 a multiple
// of the chunk (8 / WM) x 8 x NT, and kC1 either 0 or C1.
template <class YOp, int WM, int NT, int kC1 = 0>
cudaError_t tail_x1_launch(const TailArgs& a, const void* w1, const void* b1,
                           void* y, void* x1, int64_t P, int C1,
                           cudaStream_t stream) {
  constexpr int BM = 16 * WM;
  const size_t smem = tail_x1_smem_bytes(a.C, BM, (8 / WM) * 8 * NT);
  cudaError_t err = tail_x1_allow_smem<YOp, WM, NT, kC1>(smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (P + BM - 1) / BM;
  if (blocks > 0) {
    tail_x1_kernel<YOp, WM, NT, kC1><<<(unsigned)blocks, kX1Threads, smem,
                                       stream>>>(
        a, static_cast<const __nv_bfloat16*>(w1),
        static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(x1), P, C1);
  }
  return cudaGetLastError();
}

}  // namespace
