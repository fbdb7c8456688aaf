// Single-token decode attention against a dense KV cache, CUDA for sm_90a.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (Pallas TPU,
// body _decode_kernel): one query token per (batch row, q-head) against a
// (b, hkv, S, d) cache, masked by the row's valid length cache_len[b]
// (current token included), an optional sliding window and softcap.
//
// Bound on the H100: memory.  Each row reads its valid K/V once and does
// ~2 * 2 * d FLOPs per key per q-head, ~g FLOP/B with g = hq / hkv, so the
// least time is the valid K/V bytes over 3.35 TB/s.  Design, as
// on the TPU: one block per (batch row, kv-head) serves all g grouped q-heads
// (g <= 16), so that head's K/V stream through shared memory exactly once per
// step; blocks stop at the row's valid length instead of sweeping S.
#include "attention_common.cuh"

namespace repro {

struct DecodeParams {
  const void* q;  // (b, hq, 1, d), strided
  const void* k;  // (b, hkv, S, d), strided
  const void* v;  // (b, hkv, S, dv), strided
  const int* cache_len;  // (b,)
  void* out;  // (b, hq, 1, dv), contiguous
  int hkv, g, S, window;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float softcap, scale;
};

constexpr int DECODE_R = 4;                      // rows per warp (max)
constexpr int DECODE_ROWS = WARPS * DECODE_R;    // max grouped q-heads

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeParams p) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + DECODE_ROWS * D;
  float* vs = ks + BK * (D + 1);
  __shared__ int lo[DECODE_ROWS], hi[DECODE_ROWS];
  __shared__ T* out[DECODE_ROWS];

  const int b = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int hq = p.hkv * p.g;
  const int len = p.cache_len[b];
  const int rhi = min(len, p.S);
  const int rlo = p.window > 0 ? max(len - p.window, 0) : 0;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;

  for (int e = threadIdx.x; e < DECODE_ROWS * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    qs[e] = r < p.g ? to_f32(q[(kvh * p.g + r) * p.q_sh + c]) * p.scale : 0.f;
  }
  if (threadIdx.x < DECODE_ROWS) {
    const int r = threadIdx.x;
    const bool active = r < p.g;
    lo[r] = active ? rlo : 0;
    hi[r] = active ? rhi : 0;
    out[r] = active ? static_cast<T*>(p.out) +
                          (static_cast<long long>(b) * hq + kvh * p.g + r) * DV
                    : nullptr;
  }
  __syncthreads();

  attend_rows<T, D, DV, DECODE_R>(
      qs, lo, hi, out, rlo, rhi,
      static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
      DenseKeys{p.k_ss, p.v_ss}, p.softcap, ks, vs);
}

struct DecodeLaunch {
  DecodeParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <int D, int DV>
  cudaError_t operator()() const {
    const dim3 grid(batch * p.hkv);
    const size_t smem = attend_smem_bytes<D, DV, DECODE_R>();
    if (dtype == DTYPE_BF16)
      return launch(decode_kernel<__nv_bfloat16, D, DV>, grid, smem, stream, p);
    if (dtype == DTYPE_F32)
      return launch(decode_kernel<float, D, DV>, grid, smem, stream, p);
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, int dtype, int b, int hq, int hkv, int S, int d, int dv,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int window,
    float softcap, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::DECODE_ROWS)
    return cudaErrorInvalidValue;
  repro::DecodeLaunch f;
  f.p = repro::DecodeParams{q, k, v, static_cast<const int*>(cache_len), out,
                            hkv, hq / hkv, S, window,
                            q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            softcap, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims(d, dv, f);
}
