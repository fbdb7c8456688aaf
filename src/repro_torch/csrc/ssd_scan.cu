// Mamba2 SSD chunk scan, CUDA for sm_90a.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan (Pallas TPU, body
// _ssd_kernel): the chunked state-space-duality scan of one (batch, head)
// from a zero state.  For each chunk of length T, with a = dt * A and
// a_cum its running sum inside the chunk:
//   y[s]  = sum_{t<=s} (C[s].B[t]) exp(a_cum[s] - a_cum[t]) x[t] dt[t]
//         + exp(a_cum[s]) C[s] . h                     (h: state entering)
//   h    <- exp(a_cum[T-1]) h + sum_t exp(a_cum[T-1] - a_cum[t]) x[t] dt[t] B[t]^T
// and the last chunk's h is the final state.  Everything is float32 inside,
// as in the Pallas body; y is written in x's type.
//
// Bound on the H100: at the SCOPE prefill shape (b 56, l 49, h 64, p 64,
// n 128, one chunk of 49) a (batch, head) moves ~0.1 MB (its 32 KB f32
// final state dominates) and does ~2 MFLOP of f32 arithmetic, ~60 FLOP/B:
// above the f32 CUDA-core balance point (67 TFLOP/s / 3.35 TB/s = 20
// FLOP/B), so the f32 operations bound it, not the bytes.
//
// Design: the TPU kernel's grid walks the chunks of a (batch, head) in
// order and carries h in VMEM scratch; here one block of 256 threads owns
// a (batch, head), loops over its chunks itself, and keeps h (p x n f32,
// 32 KB at 64 x 128) in shared memory for the whole sequence.  Per chunk
// it stages B and C (T x n), x * dt (T x p) and a_cum in shared memory
// (row strides n + 1, so lanes walking different rows hit different
// banks), then:
//   - each warp takes rows s in turn: its lanes score the keys t <= s
//     (C[s].B[t] times the decay, exp taken only where t <= s), then sum
//     the weighted x * dt rows and, from the second chunk on, C[s].h for
//     their columns of y;
//   - after a block barrier, every thread updates its share of h in place.
// Plain FMAs out of shared memory, no tensor cores: simple and right
// first.  The TPU wrapper's transposes to a per-head layout (BlockSpec
// tiling) have no counterpart: x, dt, B and C are read through strides.
// Shared memory grows with T (about 98 KB at T = 49, 203 KB at T = 128
// with p 64 and n 128), above 48 KB only after cudaFuncSetAttribute, made
// once per size (see launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_ssd {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 128;
constexpr size_t MAX_SMEM = 232448;  // 227 KB of dynamic shared memory

// dtype codes shared with the Python wrapper
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

struct SsdParams {
  const void* x;       // (b, l, h, p), strided, last dim contiguous
  const float* dt;     // (b, l, h), strided
  const void* A;       // (h,), contiguous
  const float* B;      // (b, l, n), strided, last dim contiguous
  const float* C;      // (b, l, n), strided, last dim contiguous
  void* y;             // (b, l, h, p), contiguous, x's type
  float* state;        // (b, h, p, n), contiguous
  int a_bf16;
  int H, L, P, N, T;
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX> __device__ __forceinline__ TX from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Floats of dynamic shared memory for chunk T, head dim P, state N (the
// Python wrapper's smem_bytes mirrors it).
inline size_t ssd_smem_floats(int T, int P, int N) {
  return size_t(P) * (N + 1) + size_t(T) * P + 2 * size_t(T) * (N + 1) +
         2 * size_t(T) + size_t(WARPS) * T;
}

template <typename TX>
__global__ void __launch_bounds__(THREADS) ssd_kernel(const SsdParams p) {
  extern __shared__ float smem[];
  const int NS = p.N + 1;             // padded row stride of h, B and C
  float* hs = smem;                   // (P, NS) state h
  float* xs = hs + p.P * NS;          // (T, P)  x * dt
  float* bs = xs + p.T * p.P;         // (T, NS) B
  float* cs = bs + p.T * NS;          // (T, NS) C
  float* acum = cs + p.T * NS;        // (T)     a_cum inside the chunk
  float* decay = acum + p.T;          // (T)     dt, then exp(a_total - a_cum)
  float* wrow = decay + p.T;          // (WARPS, T) one row of weights a warp

  const int bi = blockIdx.x / p.H, hi = blockIdx.x - bi * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TX* x = static_cast<const TX*>(p.x) + bi * p.x_sb + hi * p.x_sh;
  const float* dt = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  TX* y = static_cast<TX*>(p.y);
  const float A =
      p.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.A)[hi])
               : static_cast<const float*>(p.A)[hi];
  float* w = wrow + warp * p.T;

  for (int e = tid; e < p.P * NS; e += THREADS) hs[e] = 0.f;

  const int nc = p.L / p.T;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * p.T;
    __syncthreads();  // the previous chunk is done with the staged buffers
    for (int t = tid; t < p.T; t += THREADS) decay[t] = dt[(t0 + t) * p.dt_sl];
    for (int e = tid; e < p.T * p.N; e += THREADS) {
      const int t = e / p.N, k = e - t * p.N;
      bs[t * NS + k] = Bg[(t0 + t) * p.b_sl + k];
      cs[t * NS + k] = Cg[(t0 + t) * p.c_sl + k];
    }
    __syncthreads();
    for (int e = tid; e < p.T * p.P; e += THREADS) {
      const int t = e / p.P, j = e - t * p.P;
      xs[e] = to_f32(x[(t0 + t) * p.x_sl + j]) * decay[t];
    }
    if (tid == 0) {  // a = dt * A rounded, then summed in order
      float run = 0.f;
      for (int t = 0; t < p.T; ++t) {
        run = __fadd_rn(run, __fmul_rn(decay[t], A));
        acum[t] = run;
      }
    }
    __syncthreads();
    const float a_total = acum[p.T - 1];
    for (int t = tid; t < p.T; t += THREADS)
      decay[t] = expf(a_total - acum[t]);  // read after the next barrier

    // y: warp `warp` takes rows s = warp, warp + WARPS, ...
    for (int s = warp; s < p.T; s += WARPS) {
      const float as = acum[s];
      const float* crow = cs + s * NS;
      for (int t = lane; t <= s; t += 32) {
        const float* brow = bs + t * NS;
        float dot = 0.f;
        for (int k = 0; k < p.N; ++k) dot = fmaf(crow[k], brow[k], dot);
        w[t] = dot * expf(as - acum[t]);
      }
      __syncwarp();
      const float e_out = expf(as);
      TX* yrow = y + ((static_cast<long long>(bi) * p.L + t0 + s) * p.H + hi) *
                         p.P;
      for (int j = lane; j < p.P; j += 32) {
        float acc = 0.f;
        for (int t = 0; t <= s; ++t) acc = fmaf(w[t], xs[t * p.P + j], acc);
        if (c > 0) {  // the state entering the first chunk is zero
          const float* hrow = hs + j * NS;
          float off = 0.f;
          for (int k = 0; k < p.N; ++k) off = fmaf(crow[k], hrow[k], off);
          acc = fmaf(e_out, off, acc);
        }
        yrow[j] = from_f32<TX>(acc);
      }
      __syncwarp();  // w is this warp's again for its next row
    }
    __syncthreads();

    // h <- exp(a_total) h + sum_t decay[t] (x dt)[t] B[t]^T, in place: each
    // thread reads and writes only its own elements
    const float e_total = expf(a_total);
    for (int e = tid; e < p.P * p.N; e += THREADS) {
      const int j = e / p.N, k = e - j * p.N;
      float acc = 0.f;
      for (int t = 0; t < p.T; ++t)
        acc = fmaf(xs[t * p.P + j] * decay[t], bs[t * NS + k], acc);
      hs[j * NS + k] = fmaf(e_total, hs[j * NS + k], acc);
    }
  }

  // each thread writes back the elements of h it updated last
  float* st = p.state + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N;
  for (int e = tid; e < p.P * p.N; e += THREADS) {
    const int j = e / p.N, k = e - j * p.N;
    st[e] = hs[j * NS + k];
  }
}

// Launch with `smem` bytes of dynamic shared memory.  The opt-in above 48 KB
// is made once per instantiation, device and size — at the first launch,
// so a CUDA graph that captures later launches records no attribute call.
template <typename TX>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const SsdParams& p) {
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > opted_in[dev])) {
    e = cudaFuncSetAttribute(ssd_kernel<TX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted_in[dev] = smem;
  }
  ssd_kernel<TX><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_ssd

extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    void* y, void* state, int x_dtype, int a_dtype, int b, int l, int h, int p,
    int n, int chunk, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  using namespace repro_ssd;
  if (b <= 0 || l <= 0 || h <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      l % chunk != 0 || p <= 0 || n <= 0 ||
      (a_dtype != DTYPE_F32 && a_dtype != DTYPE_BF16))
    return cudaErrorInvalidValue;
  const size_t smem = ssd_smem_floats(chunk, p, n) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const SsdParams prm{x,    static_cast<const float*>(dt), A,
                      static_cast<const float*>(B), static_cast<const float*>(C),
                      y,    static_cast<float*>(state), a_dtype == DTYPE_BF16,
                      h,    l,    p,    n,    chunk,
                      x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb,
                      c_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DTYPE_BF16) return launch<__nv_bfloat16>(b * h, smem, s, prm);
  if (x_dtype == DTYPE_F32) return launch<float>(b * h, smem, s, prm);
  return cudaErrorInvalidValue;
}
