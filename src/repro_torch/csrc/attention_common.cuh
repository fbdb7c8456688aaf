// Shared helpers of the attention kernels, and the block routine of the f32
// flash-prefill kernel (flash_attention.cu).  The decode kernels run their
// own body, decode_block in decode_common.cuh; the bf16 flash kernel runs
// on tensor cores (mma_bf16.cuh).
//
// attend_rows: a block owns up to ROWS = WARPS * R query rows that all read
// the same (batch, kv-head) K/V stream.  Row rr lives in warp (rr % WARPS),
// slot (rr / WARPS), and may attend the keys kpos in [lo[rr], hi[rr]) —
// that one interval expresses every mask the TPU kernels apply (padding,
// causal with q_offset, sliding window).  K/V stream through shared memory
// in tiles of BK = 32 keys (one key per lane when scoring), as f32, and
// each row keeps an online softmax (running max m, denominator l, weighted
// values acc) in registers: the f32 math, the NEG_INF masking and the
// fully-masked-row guards (m_safe, l == 0 -> 1) are those of
// repro/kernels/flash_attention.py::_flash_kernel, so a row with no valid
// key writes 0.  Tiles that lie wholly outside a row's interval are skipped
// for that row: on them the TPU kernel adds p = 0 with alpha = 1, a no-op.
// Where key kpos lives is a policy (Keys); the f32 flash kernel passes
// DenseKeys for a contiguous (.., S, d) cache.
//
// Plain CUDA cores (fmaf), no tensor cores, TMA or wgmma: the f32 path
// keeps the 2e-5 parity that tensor cores cannot.  Registers per lane:
// R * ceil(DV / 32) accumulators; where 32 does not divide DV (zamba2's
// 112) only the first DV % 32 lanes own a column of the last group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Dynamic shared memory of one block: q rows, one K tile (rows padded by one
// float so the 32 lanes of a warp read 32 different banks), one V tile.
template <int D, int DV, int R>
constexpr size_t attend_smem_bytes() {
  return (size_t(WARPS * R) * D + size_t(BK) * (D + 1) + size_t(BK) * DV) *
         sizeof(float);
}

// Key addresses of a dense cache: key j of this (batch, kv-head) starts at
// base + j * ss.
struct DenseKeys {
  long long k_ss, v_ss;
  __device__ __forceinline__ long long k(int kpos) const { return kpos * k_ss; }
  __device__ __forceinline__ long long v(int kpos) const { return kpos * v_ss; }
};

// qs: the block's ROWS query rows, f32, already multiplied by the scale.
// lo/hi: per-row key interval; a row with lo >= hi attends nothing.
// out: per-row output pointer (DV contiguous elements) or nullptr.
// [key_lo, key_hi): union of the rows' intervals (what the block streams).
// kp/vp: K/V bases of this (batch, kv-head); key j starts at
// kp + keys.k(j) and vp + keys.v(j).
// lse: per-row pointer (or nullptr) for the row's log-sum-exp m + ln l of
// its scaled (softcapped) scores, +inf for a row with no key; or nullptr.
template <typename T, int D, int DV, int R, typename Keys>
__device__ void attend_rows(const float* __restrict__ qs,
                            const int* __restrict__ lo, const int* __restrict__ hi,
                            T* const* __restrict__ out, int key_lo, int key_hi,
                            const T* __restrict__ kp, const T* __restrict__ vp,
                            const Keys keys, float softcap, float* ks,
                            float* vs, float* const* lse = nullptr) {
  static_assert(DV % 16 == 0, "DV must be a multiple of 16");
  constexpr int C = (DV + 31) / 32;  // output columns per lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // whether this lane owns column (C - 1) * 32 + lane: always where 32
  // divides DV
  const bool owns_last = DV % 32 == 0 || lane < DV % 32;

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = (key_lo / BK) * BK; t0 < key_hi; t0 += BK) {
    __syncthreads();  // the previous tile is consumed by every warp
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int j = e / D, c = e - j * D;
      const int kpos = t0 + j;
      ks[j * (D + 1) + c] = kpos < key_hi ? to_f32(kp[keys.k(kpos) + c]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * DV; e += THREADS) {
      const int j = e / DV, c = e - j * DV;
      const int kpos = t0 + j;
      vs[e] = kpos < key_hi ? to_f32(vp[keys.v(kpos) + c]) : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * WARPS + warp;
      const int rlo = lo[row], rhi = hi[row];
      // warp-uniform: an empty row, or a tile outside this row's interval
      if (rlo >= rhi || t0 >= rhi || t0 + BK <= rlo) continue;
      const float* qr = qs + row * D;
      const float* kr = ks + lane * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool valid = kpos >= rlo && kpos < rhi;
      s = valid ? s : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
      const float p = valid ? expf(s - m_safe) : 0.f;
      const float alpha = m[r] <= NEG_INF ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL_MASK, p, j);
        const float* vr = vs + j * DV + lane;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c < C - 1 || owns_last)
            acc[r][c] = fmaf(pj, vr[c * 32], acc[r][c]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    T* o = out[r * WARPS + warp];
    if (o == nullptr) continue;
    if (lse != nullptr && lse[r * WARPS + warp] != nullptr && lane == 0)
      *lse[r * WARPS + warp] = l[r] == 0.f ? INFINITY : m[r] + logf(l[r]);
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < C - 1 || owns_last)
        o[c * 32 + lane] = from_f32<T>(acc[r][c] / denom);
  }
}

// Runs f.template operator()<D, DV>() for the (d, dv) pair, or returns
// cudaErrorInvalidValue when either head dim is not one the kernels take.
template <int D, typename F>
cudaError_t dispatch_dv(int dv, F&& f) {
  switch (dv) {
    case 32: return f.template operator()<D, 32>();
    case 64: return f.template operator()<D, 64>();
    case 128: return f.template operator()<D, 128>();
    case 256: return f.template operator()<D, 256>();
    default: return cudaErrorInvalidValue;
  }
}

// Any pair of 32, 64, 128 and 256, and d = dv = one of SQUARE: the head
// dims a kernel takes only with dv = d, which each kernel lists for itself
// (the flash kernels, forward and backward, and both decode kernels take
// zamba2's 112).
template <int... SQUARE, typename F>
cudaError_t dispatch_head_dims(int d, int dv, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  if (((d == SQUARE && dv == SQUARE &&
        (err = f.template operator()<SQUARE, SQUARE>(), true)) || ...))
    return err;
  switch (d) {
    case 32: return dispatch_dv<32>(dv, f);
    case 64: return dispatch_dv<64>(dv, f);
    case 128: return dispatch_dv<128>(dv, f);
    case 256: return dispatch_dv<256>(dv, f);
    default: return cudaErrorInvalidValue;
  }
}

// A (d, dv) pair a kernel takes besides those of dispatch_head_dims.
template <int D, int DV>
struct HeadPair {};

template <int D, int DV, typename F>
bool run_pair(HeadPair<D, DV>, int d, int dv, F& f, cudaError_t& err) {
  if (d != D || dv != DV) return false;
  err = f.template operator()<D, DV>();
  return true;
}

// Any pair of 32, 64, 128 and 256, and each HeadPair<D, DV> of PAIRS: the
// pairs a kernel lists for itself where dv may differ from d (the flash
// forward takes MLA's (192, 128) and, on reduced configs, (48, 32)).
template <typename... PAIRS, typename F>
cudaError_t dispatch_head_pairs(int d, int dv, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  if ((run_pair(PAIRS{}, d, dv, f, err) || ...)) return err;
  return dispatch_head_dims<>(d, dv, f);
}

// Launch helper: raise the dynamic shared-memory cap when a configuration
// needs more than the default 48 KB, then launch and report the launch error.
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& p, int threads = THREADS) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro
