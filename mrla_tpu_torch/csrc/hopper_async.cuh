// The tensor-core and asynchronous-copy building blocks shared by the stage
// kernel (mrla_stage4.cu) and the tail + next-conv1 kernel (tail_x1.cuh):
//
//   * cp.async: 16-byte copies global -> shared that bypass L1 and the
//     registers, committed in groups and waited on a group at a time, so a
//     ring of K chunks fills while the tensor cores work on another stage;
//   * ldmatrix and mma.sync m16n8k16: a warp's fragments in one
//     instruction, and its product;
//   * wgmma: the descriptor of a 128-byte-swizzled shared-memory operand and
//     the fence / commit / wait around asynchronous warpgroup products.
#pragma once

#include <stdint.h>

namespace {

// 16 bytes global -> shared, past L1.  With 0 source bytes (pred false) the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i of every lane receives its
// pair of matrix i (row lane / 4, columns 2 (lane % 4) and + 1): the A
// fragment of mma.sync m16n8k16, or the B fragments of two n8 tiles.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// mma.sync m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory operand of wgmma: a K-major tile of 128-byte rows in the
// 128-byte swizzle (the 16-byte chunk c of row r sits at chunk c ^ (r & 7)),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned.  A k16 step
// moves the start address on by 32 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace
