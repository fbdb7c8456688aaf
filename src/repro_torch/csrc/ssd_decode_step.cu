// Mamba2 SSD decode step, in place, CUDA for sm_90a.
//
// Replaces the reference's single-token recurrence ssd_decode_step
// (repro/kernels/ref.py, exported beside the Pallas scan by
// repro/kernels/ops.py:308), which runs as plain XLA: no Pallas kernel.
// For each (batch, head), with a = exp(dt A):
//   state <- state a + (x dt) B^T          (p x n)
//   y     <- state C                       (p), in float32
// The new state is written over the old one, in the tensor the caller
// gave: the model's cache (a layer view of the stacked one), so no new
// state is allocated and no copy follows.
//
// Bound on the H100: bytes.  At the SCOPE decode shape (b 56, h 64, p 64,
// n 128) the state is 117 MB of f32, read once and written once: 234.9
// MB / 3.35 TB/s = 0.070 ms; 4 FLOPs per state element is 0.5 FLOP/B,
// far below the f32 balance point.  The plain version makes ~9 passes
// over it (the update einsum, the decay, the add, the y einsum, the copy
// into the cache).
//
// Design: one pass.  One block of 256 threads per (batch, head); warp w
// takes the p-rows w, w + 8, ... and a lane a float4 of n, so a warp
// reads 512 contiguous bytes of a row.  Every thread issues the 16-byte
// loads of all ROWS of its rows before any arithmetic (8 loads in flight a
// thread at p 64, n 128), updates them with one FMA an element
// (fma(state, a, x dt B)), stores them back to the same addresses, and
// sums state C; a warp-shuffle butterfly over the lanes gives y[j].  The
// state is read through its batch, head and row strides (a layer view);
// its rows must be contiguous and 16-byte aligned, and n a multiple of 4
// up to MAX_N, which the wrapper checks.  x, dt, B and C are read value
// by value through any strides: the model passes them as slices of its
// conv output, whose batch dim is the fastest.  B and C are gathered once
// a block into shared memory while the first state loads are in flight.
// No atomics: two launches on the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_ssd_step {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;              // p-rows a warp keeps in flight
constexpr int MAX_N = 4096;          // B and C in 32 KB of shared memory

// dtype codes shared with the Python wrapper
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

struct StepParams {
  float* state;        // (b, h, p, n), strided, rows contiguous, in place
  const float* x;      // (b, h, p), strided
  const float* dt;     // (b, h), strided
  const void* A;       // (h,), contiguous
  const float* B;      // (b, n), strided
  const float* C;      // (b, n), strided
  float* y;            // (b, h, p), contiguous
  int a_bf16;
  int H, P, N;
  long long s_sb, s_sh, s_sp, x_sb, x_sh, x_sp, dt_sb, dt_sh, b_sb, b_sn,
      c_sb, c_sn;
};

// ROWS 16-byte state loads of rows j0 + r WARPS, quad kq, all issued
// before any is used
__device__ __forceinline__ void load_rows(float4 (&s)[ROWS], const float* st,
                                          long long s_sp, int P, int j0,
                                          int kq) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = j0 + r * WARPS;
    if (j < P) s[r] = *reinterpret_cast<const float4*>(st + j * s_sp + 4 * kq);
  }
}

__global__ void __launch_bounds__(THREADS) ssd_step_kernel(const StepParams p) {
  extern __shared__ __align__(16) float bc[];  // B (N), then C (N)
  const int bi = blockIdx.x / p.H, hi = blockIdx.x - bi * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NQ = p.N / 4;
  float* st = p.state + bi * p.s_sb + hi * p.s_sh;
  const float* x = p.x + bi * p.x_sb + hi * p.x_sh;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;

  // the first pass's state rows in flight, then B and C (strided in the
  // model's layout) gathered once into shared memory
  float4 s[ROWS];
  if (lane < NQ) load_rows(s, st, p.s_sp, p.P, warp, lane);
  for (int k = tid; k < p.N; k += THREADS) {
    bc[k] = Bg[k * p.b_sn];
    bc[p.N + k] = Cg[k * p.c_sn];
  }
  const float dtv = p.dt[bi * p.dt_sb + hi * p.dt_sh];
  const float A =
      p.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.A)[hi])
               : static_cast<const float*>(p.A)[hi];
  const float a = expf(dtv * A);
  float* y = p.y + (static_cast<long long>(bi) * p.H + hi) * p.P;
  __syncthreads();

  for (int j0 = warp; j0 < p.P; j0 += WARPS * ROWS) {
    float yp[ROWS], u[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = j0 + r * WARPS;
      yp[r] = 0.f;
      u[r] = j < p.P ? x[j * p.x_sp] * dtv : 0.f;
    }
    for (int kq = lane; kq < NQ; kq += 32) {
      if (j0 != warp || kq != lane) load_rows(s, st, p.s_sp, p.P, j0, kq);
      const float4 b = *reinterpret_cast<const float4*>(bc + 4 * kq);
      const float4 c = *reinterpret_cast<const float4*>(bc + p.N + 4 * kq);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int j = j0 + r * WARPS;
        if (j < p.P) {
          float4 v;
          v.x = fmaf(s[r].x, a, u[r] * b.x);
          v.y = fmaf(s[r].y, a, u[r] * b.y);
          v.z = fmaf(s[r].z, a, u[r] * b.z);
          v.w = fmaf(s[r].w, a, u[r] * b.w);
          *reinterpret_cast<float4*>(st + j * p.s_sp + 4 * kq) = v;
          float acc = fmaf(v.x, c.x, yp[r]);
          acc = fmaf(v.y, c.y, acc);
          acc = fmaf(v.z, c.z, acc);
          yp[r] = fmaf(v.w, c.w, acc);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float v = yp[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int j = j0 + r * WARPS;
      if (lane == 0 && j < p.P) y[j] = v;
    }
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace repro_ssd_step

extern "C" int repro_ssd_decode_step(
    void* state, const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, int a_dtype, int b, int h, int p, int n,
    long long s_sb, long long s_sh, long long s_sp, long long x_sb,
    long long x_sh, long long x_sp, long long dt_sb, long long dt_sh,
    long long b_sb, long long b_sn, long long c_sb, long long c_sn,
    void* stream) {
  using namespace repro_ssd_step;
  if (b <= 0 || h <= 0 || p <= 0 || n <= 0 || n % 4 != 0 || n > MAX_N ||
      (a_dtype != DTYPE_F32 && a_dtype != DTYPE_BF16) || !aligned16(state) ||
      s_sb % 4 != 0 || s_sh % 4 != 0 || s_sp % 4 != 0)
    return cudaErrorInvalidValue;
  const StepParams prm{static_cast<float*>(state),
                       static_cast<const float*>(x),
                       static_cast<const float*>(dt),
                       A,
                       static_cast<const float*>(B),
                       static_cast<const float*>(C),
                       static_cast<float*>(y),
                       a_dtype == DTYPE_BF16,
                       h, p, n, s_sb, s_sh, s_sp, x_sb, x_sh, x_sp, dt_sb,
                       dt_sh, b_sb, b_sn, c_sb, c_sn};
  ssd_step_kernel<<<b * h, THREADS, 2 * n * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(prm);
  return cudaGetLastError();
}
