// Helpers shared by the bf16 tensor-core flash kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): the masks as
// one key interval a query position, the exponent, and 16-byte row copies
// into shared memory.
#pragma once

#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace repro {

constexpr float LOG2E = 1.4426950408889634f;

// 2^x, one MUFU instruction (relative error ~2^-22); 2^(-huge) = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Key interval [lo, hi) of query position qi: the one mask of every row.
// P is any parameter struct with sk, causal, window and q_offset.
template <typename P>
__device__ __forceinline__ void row_interval(const P& p, int qi, int& lo,
                                             int& hi) {
  const int qpos = qi + p.q_offset;
  hi = p.causal ? min(qpos + 1, p.sk) : p.sk;
  lo = p.window > 0 ? max(qpos - p.window + 1, 0) : 0;
}

// Union of the non-empty key intervals of positions [p0, p1].  lo(q) and
// hi(q) never decrease with q, and the positions with a non-empty interval
// form one run (causal: q + q_offset >= 0; window: q + q_offset <= sk +
// window - 2), so the union runs from the run's first lo to its last hi.
// Empty: lo = sk, hi = 0.
template <typename P>
__device__ __forceinline__ void key_span(const P& p, int p0, int p1, int& lo,
                                         int& hi) {
  if (p.causal) p0 = max(p0, -p.q_offset);
  if (p.window > 0) p1 = min(p1, p.sk + p.window - 2 - p.q_offset);
  lo = p.sk;
  hi = 0;
  if (p0 > p1) return;
  int unused;
  row_interval(p, p0, lo, unused);
  row_interval(p, p1, unused, hi);
}

// ROWS x W bf16 rows (W / 8 16-byte chunks each) into shared memory at row
// stride S; row j comes from base + (first + j) * ss.  Rows in [end, zend)
// are zero-filled, rows at or past zend left as they are.  Where the NT
// threads split evenly over the chunks, each copies one chunk column of
// every (NT / chunks)-th row; otherwise (W = 112: 14 chunks a row) thread t
// copies chunks t, t + NT, ... of the tile in row-major order.
template <int ROWS, int W, int S, int NT = THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long ss, int first, int end,
                                          int zend) {
  constexpr int C = W / 8;
  if constexpr (NT % C == 0 && ROWS % (NT / C) == 0) {
    constexpr int STEP = NT / C;
    const int j = threadIdx.x / C, c = threadIdx.x % C;
    const __nv_bfloat16* src = base + (first + j) * ss + c * 8;
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const int row = first + j + i * STEP;
      if (row < zend)
        cp_async16(dst + (j + i * STEP) * S + c * 8,
                   row < end ? src + i * STEP * ss : base, row < end);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (ROWS * C + NT - 1) / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int j = e / C, c = e - j * C, row = first + j;
      if (e < ROWS * C && row < zend)
        cp_async16(dst + j * S + c * 8,
                   row < end ? base + row * ss + c * 8 : base, row < end);
    }
  }
}

}  // namespace repro
