// Warp-level tensor-core helpers for sm_90a (also valid on sm_80+):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads, and
// the bf16 mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, row-major A,
// "col" B, i.e. B[k][n] read with k contiguous for each n):
//   A (16 x 16, 4 regs of bf16x2): a0 = (row lane/4,     k 2(lane%4) + {0,1})
//                                  a1 = (row lane/4 + 8, same k)
//                                  a2 = (row lane/4,     k 8 + 2(lane%4) + {0,1})
//                                  a3 = (row lane/4 + 8, same k as a2)
//   B (16 x 8, 2 regs):            b0 = (k 2(lane%4) + {0,1},     n lane/4)
//                                  b1 = (k 8 + 2(lane%4) + {0,1}, n lane/4)
//   C (16 x 8, 4 f32):             c0, c1 = (row lane/4,     n 2(lane%4) + {0,1})
//                                  c2, c3 = (row lane/4 + 8, same n)
// so the C fragments of two neighbouring 8-column tiles are, packed to bf16,
// the A fragment of the 16-wide k-slice they cover.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills the destination (and
// reads nothing) when !valid.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1; zero-fills the destination when
// !valid.  Both addresses must be 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and receives row lane/4, columns 2(lane%4) + {0,1} of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, transposed: lane receives rows 2(lane%4) + {0,1}, column lane/4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b: one 16 x 8 x 16 bf16 product, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace repro
